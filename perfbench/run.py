"""Run one cell of the benchmark once.

    python3 -m perfbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is looked up in ``BENCHMARK.json``
by name; its configuration is the file that ``configs`` names, its
traffic mix ``perfbench/traffic/<traffic>.json``, whose ``kind`` picks
the driver ``perfbench/drivers/<kind>.py``, and the limits of its
comparison ``perfbench/limits/<workload>.json``. With ``--trace 0`` the
result's metrics are the cell's end-to-end metrics; with ``--trace 1``
its per-layer metrics, each read by ``perfbench/metrics/<metric>.py``.
The last line of standard output is the result as one JSON object; the
compared numbers, each beside its limit, are the last lines of standard
error and the result's last key.

``--control`` runs the reference in bfloat16 in the program's place and
``--fault <name>`` breaks the timed path (``unchanged``: a training step
returns its state unchanged; ``half_batch``: the loss is the mean over
the top half of the image; ``altered``: the rendered colours are scaled
by 1.01 where they are produced). Both print the compared numbers, and
a correct run is expected to read false.
"""

from __future__ import annotations

import time

T_WALL = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gs2d_tpu")
FAULTS = ("unchanged", "half_batch", "altered")


def _process_start() -> float:
    """The wall-clock time at which this process started (Linux), or the
    time this module was first imported."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_WALL


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths.
    The port builds its kernels into ``build/gs2d_torch/`` beside its
    package."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


class _Stamps:
    def __init__(self, t0: float):
        self.t0 = t0

    def __call__(self, what: str) -> None:
        print(f"[perfbench {time.time() - self.t0:8.2f}s] {what}",
              file=sys.stderr, flush=True)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json"):
    """(benchmark, cell, configuration, traffic mix, limits)."""
    bench = json.loads(bench_path.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((bench_path.parent / configs[cell["config"]]["file"])
                     .read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    return bench, cell, cfg, traffic, limits


def end_to_end(bench: dict, workload: str) -> list:
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer(bench: dict, workload: str) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list that move an end-to-end metric it reports."""
    e2e = {m["name"] for m in end_to_end(bench, workload)}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in e2e)]


def device_info(torch, dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return info


def main(argv=None, *, bench_path: Path = ROOT / "BENCHMARK.json",
         device: str = "cuda", n: int = 0, scale: float = 1.0) -> int:
    """Run a cell; ``device``, ``n`` and ``scale`` are for tests (a CPU
    run of a tiny scene, which skips the look for a card)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=FAULTS)
    args = ap.parse_args(argv)
    t_start = _process_start()
    _caches()

    bench, cell, cfg, traffic, limits = load_cell(args.workload, bench_path)
    stamp = _Stamps(t_start)
    import torch
    stamp("torch imported")
    try:
        import gs2d_torch  # noqa: F401
        from gs2d_torch import cuda_build
    except ImportError as e:
        print(f"perfbench: the program is not here: {e}", file=sys.stderr)
        return 2
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < int(cell["chips"]):
            print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
                  f"device(s); torch sees "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        stamp("CUDA context made")
        cuda_build.build_all()
        stamp("kernels built or found")
    from .drivers import Run
    driver = importlib.import_module(f"perfbench.drivers.{traffic['kind']}")
    mode = "control" if args.control else (args.fault or "run")
    r = Run(args.workload, cfg, traffic, args.seed, args.seconds,
            bool(args.trace), dev, mode, n, scale, t_start)
    out = driver.run(r)

    checks = {}
    for name, value in out.numbers.items():
        if name not in limits:
            raise KeyError(f"no limit for {name} in limits/"
                           f"{args.workload}.json")
        checks[name] = {"value": value, "limit": limits[name]}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    metrics = {}
    if mode == "control":
        pass
    elif args.trace:
        for m in per_layer(bench, args.workload):
            mod = load_module(HERE / "metrics" / f"{m['name']}.py")
            v = mod.read(out.traced)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = dict(out.metrics, setup_s=out.setup_s)
        for m in end_to_end(bench, args.workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    bad = sorted({m.split(".")[0] for m in list(sys.modules)}
                 & set(FORBIDDEN))
    if bad:
        print(f"perfbench: the process has loaded {bad}", file=sys.stderr)
        return 3
    info = device_info(torch, dev)
    info["memory_peak_bytes"] = out.memory_peak
    result = {"correct": correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": info}
    if args.trace and out.traced is not None:
        from .trace import breakdown
        info["busy_s"] = out.traced.trace.busy_s
        info["window_s"] = out.traced.trace.window_s
        result["breakdown"] = breakdown(out.traced.trace)
    if mode != "run":
        result["mode"] = mode
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
