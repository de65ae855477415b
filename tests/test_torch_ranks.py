"""The port's multi-rank test harness (tests/test_torch_dist_common.py,
``start_ranks`` and ``Ranks.results``) on 2 gloo ranks of a trivial
worker. Its time limit bounds the parent's wait for the ranks, counted
from the call of ``results``: a parent that stays busy past the limit
after its ranks reported still gets their results in rank order, and a
rank that hangs still fails the test about the limit after the call. A
rank that raises fails it with its traceback, one that dies unreported
fails it at once, and no child outlives ``results``.

Each test first waits for the ranks that finish to exit (a rank exits
only once its result is in the queue), so what it checks does not depend
on how fast the machine spawns them.
"""

import time

import pytest

from .test_torch_dist_common import TIMEOUT_S, start_ranks, trivial_worker

TIMEOUT = 2.0


def _wait_exit(ranks, which):
    for r in which:
        ranks.procs[r].join(TIMEOUT_S)
        assert ranks.procs[r].exitcode is not None, f"rank {r} still runs"


def _none_alive(ranks):
    return not any(p.is_alive() for p in ranks.procs)


def test_results_survive_a_parent_busy_past_the_timeout():
    ranks = start_ranks(trivial_worker, 2, timeout=TIMEOUT)
    _wait_exit(ranks, (0, 1))
    time.sleep(TIMEOUT + 1.0)           # the parent's own work
    assert ranks.results() == [(0, 2), (1, 2)]
    assert _none_alive(ranks)


def test_a_hung_rank_fails_the_timeout_after_the_wait_starts():
    ranks = start_ranks(trivial_worker, 2, "hang", timeout=TIMEOUT)
    _wait_exit(ranks, (0,))
    time.sleep(TIMEOUT + 1.0)           # the parent's own work
    t0 = time.monotonic()
    with pytest.raises(AssertionError,
                       match=r"ranks \[1\] did not finish in time"):
        ranks.results()
    waited = time.monotonic() - t0
    assert TIMEOUT <= waited < TIMEOUT + 5.0, waited
    assert _none_alive(ranks)


def test_a_raising_rank_fails_with_its_traceback():
    ranks = start_ranks(trivial_worker, 2, "raise", timeout=TIMEOUT)
    _wait_exit(ranks, (0, 1))
    with pytest.raises(AssertionError) as err:
        ranks.results()
    msg = str(err.value)
    assert "rank 1:" in msg and "Traceback (most recent call last)" in msg
    assert "ValueError: rank 1 fails on purpose" in msg, msg
    assert _none_alive(ranks)


def test_a_rank_dead_unreported_fails_before_the_timeout():
    ranks = start_ranks(trivial_worker, 2, "exit")
    _wait_exit(ranks, (0, 1))
    t0 = time.monotonic()
    with pytest.raises(AssertionError,
                       match=r"a rank died: exit codes \[0, 3\]"):
        ranks.results()
    assert time.monotonic() - t0 < 10.0
    assert _none_alive(ranks)
