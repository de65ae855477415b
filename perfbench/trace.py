"""The traced window: ``torch.profiler`` over it, and what its trace says.

The trace is written as Chrome JSON to a temporary file, read back and
deleted. The window is the host span ``perfbench::window``, opened and
closed right after a ``torch.cuda.synchronize()``, so every device
operation it caused lies inside it. The device's busy time is the union
of its kernels', copies' and fills' intervals within the window; each
idle gap is put down to the innermost host operator running at its
middle, on any thread ("host, outside any operator" where none runs).
Spans that the benchmark opens around calls into the program
(``perfbench::<name>``) are kept by name, with their host durations.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from typing import NamedTuple

import torch

WINDOW = "perfbench::window"
SPAN_PREFIX = "perfbench::"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
OUTSIDE = "host, outside any operator"


class Trace(NamedTuple):
    window_s: float
    busy_s: float
    launches: int                 # kernels inside the window
    kernel_s: dict                # kernel name → summed seconds
    kernel_n: dict                # kernel name → launches
    idle_by_host: dict            # host operator → idle seconds
    spans: dict                   # span name → [host seconds]


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def span(name: str):
    """A host span in the trace, around a call into the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


def read(prof) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.unlink(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    return parse([e for e in events if e.get("ph") == "X"])


def parse(events: list) -> Trace:
    """The ``ph == "X"`` events of a Chrome trace → ``Trace``."""
    win = [e for e in events
           if e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
    if len(win) != 1:
        raise ValueError(f"the trace holds {len(win)} windows, not one")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev, host, spans = [], [], defaultdict(list)
    kernel_s, kernel_n = defaultdict(float), defaultdict(int)
    launches = 0
    for e in events:
        cat = e.get("cat", "")
        t0 = float(e["ts"])
        t1 = t0 + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            a, b = max(t0, w0), min(t1, w1)
            if b > a:
                dev.append((a, b))
                if cat == "kernel":
                    launches += 1
                    kernel_s[e["name"]] += (b - a) * 1e-6
                    kernel_n[e["name"]] += 1
        elif cat in HOST_CATS and e["name"] != WINDOW:
            if e["name"].startswith(SPAN_PREFIX) and w0 <= t0 and t1 <= w1:
                spans[e["name"][len(SPAN_PREFIX):]].append((t1 - t0) * 1e-6)
            if t1 > w0 and t0 < w1 and t1 > t0:
                host.append((t0, t1, e.get("tid", 0), e["name"]))
    busy, gaps = _union_and_gaps(dev, w0, w1)
    return Trace((w1 - w0) * 1e-6, busy * 1e-6, launches, dict(kernel_s),
                 dict(kernel_n), _attribute(gaps, host), dict(spans))


def _union_and_gaps(iv, w0, w1):
    iv.sort()
    busy, gaps, cur = 0.0, [], w0
    start = end = None
    for a, b in iv:
        if end is None or a > end:
            if end is not None:
                busy += end - start
                cur = end
            if a > cur:
                gaps.append((cur, a))
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        busy += end - start
        cur = end
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def _attribute(gaps, host) -> dict:
    """Idle seconds by the innermost host operator open at each gap's
    middle: a sweep over operator starts and ends with one stack of open
    operators per thread (their intervals nest within a thread)."""
    marks = []
    for i, (t0, t1, tid, name) in enumerate(host):
        marks.append((t0, 1, -(t1 - t0), i))        # opens, outer first
        marks.append((t1, 0, 0.0, i))               # closes before opens
    for j, (a, b) in enumerate(gaps):
        marks.append(((a + b) / 2, 2, 0.0, j))      # queries after both
    marks.sort()
    stacks = defaultdict(list)
    out = defaultdict(float)
    for t, kind, _, i in marks:
        if kind == 1:
            stacks[host[i][2]].append(i)
        elif kind == 0:
            st = stacks[host[i][2]]
            if i in st:
                st.remove(i)
        else:
            best = None
            for st in stacks.values():
                if st and (best is None or len(st) > best[0]):
                    best = (len(st), host[st[-1]][3])
            a, b = gaps[i]
            out[best[1] if best else OUTSIDE] += (b - a) * 1e-6
    return dict(out)


def breakdown(tr: Trace) -> dict:
    """The ten device operations that took most time, and the ten host
    operators under which the device idled longest."""
    top = sorted(tr.kernel_s.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(tr.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in top],
            "idle_gaps": [[k[:120], v] for k, v in idle]}
