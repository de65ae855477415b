"""Spans and counters of the port's stages, recorded while a
``torch.profiler`` runs in the process.

``span(name)`` is a context manager around one stage and ``count(name,
n)`` adds to a counter. Both check ``torch.autograd._profiler_enabled()``
and do nothing else while no profiler records: ``span`` then returns one
shared no-op context (no ``record_function``, event, allocation or clock
read). While a profiler records, a span

- enters ``torch.profiler.record_function("gs2d::" + name)``, so the
  stage shows in the profiler's trace on the device's clock;
- keeps its name, its parent (the innermost span open when it opened),
  its host interval (``perf_counter_ns``) and the counts made while it
  was the innermost open span;
- takes its device time from two timing events recorded on the current
  CUDA stream at entry and exit: the stream time between them, its
  kernels and whatever idle the host left inside it. Without CUDA the
  operations are synchronous and the device time is the host interval.
  Events are resolved without a sync: by ``Event.query()`` at the exit
  of each top-level span, and finally in ``summary()``.

The stack of open spans is one for the process: autograd's backward
thread runs while the thread that called ``torch.autograd.grad`` waits,
so the spans it opens nest under the span around that call.

Counters: ``sync``, one at each place on the step's and the render's path
where the host waits for the device (a read of a device value, a copy
from pageable host memory); ``gt.upload``, one per ground-truth upload.

``summary()`` gives per span name its calls, host and device seconds and
self seconds (the children's intervals taken out) and counts, and the
totals of each counter; ``write(path)`` writes the records and the
summary as JSON; ``reset()`` clears them. ``profiler(device)`` clears
them and starts a ``torch.profiler`` over the device's activities.
"""

from __future__ import annotations

import json
import threading
import time
from collections import defaultdict

import torch

PREFIX = "gs2d::"

_recording = torch.autograd._profiler_enabled


class _Off:
    """The context ``span`` returns while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "parent", "t0", "t1", "ev0", "ev1", "device_s",
                 "counts", "_rf")

    def __init__(self, name: str):
        self.name = name
        self.parent = None
        self.t0 = self.t1 = 0
        self.ev0 = self.ev1 = None
        self.device_s = None
        self.counts = {}

    def __enter__(self):
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        _REC.open(self)
        return self

    def __exit__(self, *exc):
        _REC.close(self)
        self._rf.__exit__(*exc)
        self._rf = None
        return False


class _Recorder:
    def __init__(self):
        self.lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        self.records = []         # every span, in the order they opened
        self.stack = []           # the spans open now
        self.pending = []         # closed spans whose events are unresolved
        self.free = []            # resolved events, for reuse
        self.totals = defaultdict(int)

    def _event(self):
        return self.free.pop() if self.free else torch.cuda.Event(
            enable_timing=True)

    def open(self, s: _Span) -> None:
        cuda = torch.cuda.is_initialized()
        with self.lock:
            s.parent = self.stack[-1] if self.stack else None
            self.stack.append(s)
            self.records.append(s)
            if cuda:
                s.ev0 = self._event()
        if cuda:
            s.ev0.record()
        s.t0 = time.perf_counter_ns()

    def close(self, s: _Span) -> None:
        s.t1 = time.perf_counter_ns()
        with self.lock:
            if s.ev0 is None:
                s.device_s = (s.t1 - s.t0) * 1e-9
            else:
                s.ev1 = self._event()
                s.ev1.record()
                self.pending.append(s)
            if s in self.stack:          # not if reset() ran while open
                self.stack.remove(s)
            if s.parent is None:
                self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Device seconds of the closed spans whose end event the stream
        has passed (all of them with ``wait``), in the order they
        closed."""
        done = 0
        for s in self.pending:
            if wait:
                s.ev1.synchronize()
            elif not s.ev1.query():
                break
            s.device_s = s.ev0.elapsed_time(s.ev1) * 1e-3
            self.free += (s.ev0, s.ev1)
            s.ev0 = s.ev1 = None
            done += 1
        del self.pending[:done]

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.totals[name] += n
            if self.stack:
                c = self.stack[-1].counts
                c[name] = c.get(name, 0) + n

    def summary(self) -> dict:
        with self.lock:
            self._resolve(wait=True)
            records = [s for s in self.records if s.t1]
            child_host = defaultdict(float)
            child_dev = defaultdict(float)
            for s in records:
                if s.parent is not None:
                    child_host[id(s.parent)] += (s.t1 - s.t0) * 1e-9
                    child_dev[id(s.parent)] += s.device_s
            spans = {}
            for s in records:
                host = (s.t1 - s.t0) * 1e-9
                a = spans.setdefault(s.name, {
                    "calls": 0, "host_s": 0.0, "host_self_s": 0.0,
                    "device_s": 0.0, "device_self_s": 0.0, "counts": {}})
                a["calls"] += 1
                a["host_s"] += host
                a["host_self_s"] += host - child_host[id(s)]
                a["device_s"] += s.device_s
                a["device_self_s"] += s.device_s - child_dev[id(s)]
                for k, v in s.counts.items():
                    a["counts"][k] = a["counts"].get(k, 0) + v
            return {"spans": spans, "counts": dict(self.totals)}

    def write(self, path: str) -> None:
        out = self.summary()
        with self.lock:
            records = [s for s in self.records if s.t1]
            index = {id(s): i for i, s in enumerate(records)}
            t_first = records[0].t0 if records else 0
            out["records"] = [
                {"name": s.name,
                 "parent": index.get(id(s.parent)),
                 "host_start_s": (s.t0 - t_first) * 1e-9,
                 "host_s": (s.t1 - s.t0) * 1e-9,
                 "device_s": s.device_s, "counts": s.counts}
                for s in records]
        with open(path, "w") as f:
            json.dump(out, f, indent=1)


_REC = _Recorder()


def span(name: str):
    """A context around one stage, named ``gs2d::<name>`` in the
    profiler's trace; the shared no-op context while no profiler
    records."""
    if not _recording():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``, and to the innermost open
    span's count of it, while a profiler records."""
    if _recording():
        _REC.count(name, n)


def summary() -> dict:
    """``{"spans": {name: {calls, host_s, host_self_s, device_s,
    device_self_s, counts}}, "counts": {name: total}}`` over the spans
    closed since the last ``reset()``."""
    return _REC.summary()


def reset() -> None:
    """Forget every record and count."""
    with _REC.lock:
        _REC.reset()


def write(path: str) -> None:
    """The records (one per span: name, parent's index, host start and
    seconds, device seconds, counts) and the summary, as JSON."""
    _REC.write(path)


def profiler(device):
    """Clear the records and start a ``torch.profiler`` over the CPU and,
    on a CUDA device, the card; the caller stops it."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    reset()
    prof = profile(activities=acts)
    prof.start()
    return prof
