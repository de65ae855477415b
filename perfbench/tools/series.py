"""Run a cell several times, one process after another, as the check
does, and summarise the spread of each end-to-end metric.

    python3 -m perfbench.tools.series --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--trace 1] [--out <dir>] [-- <extra args>]

Each run's standard output and error go to ``<dir>/<workload>.<seed>.
<trace>.<k>.{out,err}`` (k counts the runs of that seed); each run's result line is printed with its exit
code, then, per metric, the values, their median and the spread (the
distance between the quartiles of ``statistics.quantiles(values, n=4)``
over the median) of all runs and without the run farthest from the
median. Not part of a run: ``perfbench.run`` never imports it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values):
    if len(values) < 2:
        return float("nan")
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def trimmed(values):
    """The spread without the value farthest from the median, where that
    narrows it."""
    if len(values) < 4:
        return spread(values)
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    rest = values[:far] + values[far + 1:]
    return min(spread(values), spread(rest))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    extra = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--seeds", nargs="+", type=int, required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", default="build/perfbench_runs")
    ap.add_argument("--timeout", type=float, default=400)
    a = ap.parse_args(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    values = {}
    for seed in a.seeds:
        stem = out / f"{a.workload}.{seed}.{a.trace}"
        k = 0
        while (out / f"{stem.name}.{k}.out").exists():
            k += 1
        stem = out / f"{stem.name}.{k}"
        cmd = [sys.executable, "-m", "perfbench.run", "--workload",
               a.workload, "--seed", str(seed), "--seconds", a.seconds,
               "--trace", a.trace, *extra]
        t0 = time.time()
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=a.timeout)
            rc, so, se = p.returncode, p.stdout, p.stderr
        except subprocess.TimeoutExpired as e:
            rc, so, se = 124, e.stdout or "", e.stderr or ""
            so = so.decode() if isinstance(so, bytes) else so
            se = se.decode() if isinstance(se, bytes) else se
        (out / (stem.name + ".out")).write_text(so)
        (out / (stem.name + ".err")).write_text(se)
        lines = so.strip().splitlines()
        last = lines[-1] if lines else ""
        print(f"{a.workload} seed={seed} trace={a.trace} rc={rc} "
              f"wall={time.time() - t0:.1f}s", flush=True)
        print(last if last.startswith("{") else se[-3000:], flush=True)
        try:
            res = json.loads(last)
        except ValueError:
            continue
        for k, v in res.get("metrics", {}).items():
            values.setdefault(k, []).append(v["value"])
    for k, v in values.items():
        print(f"{k}: n={len(v)} median={statistics.median(v)!r} "
              f"spread={spread(v)!r} trimmed={trimmed(v)!r} values={v}",
              flush=True)


if __name__ == "__main__":
    main()
