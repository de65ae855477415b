"""What the per-layer metrics' readers share.

A reader (``perfbench/metrics/<metric>.py``) gets the traced run's
``Traced``: the cell's kind (``train`` or ``render``), the trace
(``perfbench.trace.Trace``), the units of work done in the traced window
(iterations or views) and, for each, the geometry counts of its view
(``pairs``, ``visible``, ``surfels``, ``pixels``). It returns a number,
or None where the run has nothing for it to read.
"""

from __future__ import annotations

from typing import List, NamedTuple

from . import counts
from .trace import Trace

KERNELS = {"k1": "rasterize_fwd_kernel", "k2": "rasterize_bwd_kernel"}


class Traced(NamedTuple):
    kind: str
    trace: Trace
    units: int
    views: List[dict]


def idle_pct(t: Traced, kind: str):
    if t.kind != kind or t.trace.window_s <= 0 or t.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.trace.busy_s / t.trace.window_s)


def launches_per_unit(t: Traced, kind: str):
    if t.kind != kind or t.units <= 0 or t.trace.launches <= 0:
        return None
    return t.trace.launches / t.units


def roofline_pct(t: Traced, kind: str, kernel: str):
    """The kernel's least time for the views of the window over its
    device time there: the mean bound of a view times the launches."""
    if t.kind != kind or not t.views:
        return None
    names = [k for k in t.trace.kernel_s if KERNELS[kernel] in k]
    secs = sum(t.trace.kernel_s[k] for k in names)
    calls = sum(t.trace.kernel_n[k] for k in names)
    if secs <= 0 or calls <= 0:
        return None
    f = counts.k1 if kernel == "k1" else counts.k2
    bound = sum(f(v)["seconds"] for v in t.views) / len(t.views)
    return 100.0 * bound * calls / secs


def span_ms(t: Traced, kind: str, name: str):
    d = t.trace.spans.get(name, [])
    if t.kind != kind or not d:
        return None
    return 1e3 * sum(d) / len(d)


def mfu_pct(t: Traced, kind: str):
    if t.kind != kind or not t.views or t.trace.window_s <= 0:
        return None
    f = counts.train_ops if kind == "train" else counts.render_ops
    ops = sum(f(v) for v in t.views) / len(t.views)
    return 100.0 * ops * t.units / t.trace.window_s / counts.PEAK_FLOPS
