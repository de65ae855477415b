"""The port's multi-process bring-up and rank-local data placement
(gs2d_torch/parallel/multihost.py) against the JAX package's
(tests/test_multihost.py): the four cases of ``initialize_distributed``
with ``init_process_group`` replaced, the camera shards, and on 4 gloo
ranks each rank's rows and the view assembled from every rank's band
against the JAX functions on a 4-device mesh; a data-parallel step fed the
band-assembled view equals the step fed the whole view (rtol 1e-6, as
tests/test_multihost.py:117).
"""

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import Mesh

from gs2d_torch.parallel import multihost as mh
from gs2d_tpu.parallel import multihost as jmh

from .test_torch_dist_common import multihost_worker, start_ranks
from .test_torch_parallel import _jax_state

RANKS = 4


def _no_group(monkeypatch, init):
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 4)


def test_initialize_is_noop_without_launcher_env(monkeypatch):
    for v in mh._LAUNCHER_ENV_VARS:
        monkeypatch.delenv(v, raising=False)
    called = []
    _no_group(monkeypatch, lambda **kw: called.append(kw))
    assert mh.initialize_distributed() is False
    assert called == []


def test_initialize_explicit_args_reach_torch(monkeypatch):
    called = []
    _no_group(monkeypatch, lambda **kw: called.append(kw))
    assert mh.initialize_distributed("10.0.0.1:1234", 4, 2, backend="gloo")
    assert called == [{"backend": "gloo",
                       "init_method": "tcp://10.0.0.1:1234",
                       "world_size": 4, "rank": 2, "timeout": mh.TIMEOUT}]


def test_initialize_env_triggered_and_failure_propagates(monkeypatch):
    # a launcher's variable marks a distributed launch: a failure must not
    # be swallowed into a single-process run
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")

    def boom(**kw):
        assert kw["init_method"] == "env://" and kw["backend"] == "gloo"
        raise RuntimeError("rendezvous unreachable")

    _no_group(monkeypatch, boom)
    with pytest.raises(RuntimeError, match="rendezvous unreachable"):
        mh.initialize_distributed(backend="gloo")


def test_initialize_idempotent(monkeypatch):
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: pytest.fail("initialized again"))
    assert mh.initialize_distributed("addr:1", 2, 0) is True


def test_local_camera_shard_partitions():
    cams = list(range(11))
    shards = [mh.local_camera_shard(cams, num_shards=3, shard_id=i)
              for i in range(3)]
    assert shards == [jmh.local_camera_shard(cams, num_shards=3, shard_id=i)
                      for i in range(3)]
    assert sorted(sum(shards, [])) == cams
    # without a process group: one shard, every camera
    assert mh.local_camera_shard(cams) == cams and mh.is_main_process()


def test_rows_and_gt_assembly_on_four_ranks():
    H, W = 64, 32
    gt = np.arange(3 * H * W, dtype=np.float32).reshape(3, H, W)
    _, fields = _jax_state()
    step_gt = np.random.default_rng(1).random((3, 128, 128)).astype(
        np.float32)
    ranks = start_ranks(multihost_worker, RANKS, gt, fields, step_gt)
    # the JAX package on a 4-device mesh: each device's rows of the
    # row-sharded view, and the view assembled from the bands
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("data",))
    garr = jmh.global_gt_from_local_rows(gt, mesh, H)
    jax_rows = sorted((s.index[1].start or 0, s.index[1].stop or H)
                      for s in garr.addressable_shards)
    results = ranks.results()

    assert [r["rows"] for r in results] == jax_rows
    for r in results:
        np.testing.assert_array_equal(r["gt"], np.asarray(garr))
    assert [r["main"] for r in results] == [True, False, False, False]
    assert [r["shard"] for r in results] == [
        jmh.local_camera_shard(list(range(11)), RANKS, i)
        for i in range(RANKS)]
    for r in results:
        np.testing.assert_allclose(r["banded"]["loss"], r["whole"]["loss"],
                                   rtol=1e-6)
        np.testing.assert_array_equal(r["banded"]["xyz"], r["whole"]["xyz"])
