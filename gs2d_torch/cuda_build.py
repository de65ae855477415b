"""Build the package's hand-written CUDA kernels and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface; ``nvcc`` compiles it into
``build/gs2d_torch/lib<name>-<hash>.so`` beside the package at first use
(the hash covers the source and the flags, so an edit rebuilds). Nothing
is compiled when a module is imported: the CPU tests import every module
on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS = ("rasterize_fwd", "rasterize_bwd", "gather_rows")

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "gs2d_torch"
# -fmad=false keeps one rounding per operation, as the plain PyTorch
# versions round, so per-pixel decisions agree bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every kernel not yet built, one ``nvcc`` per source, all
    started together. Returns {name: compiler report} (``ptxas -v``
    register and shared-memory use) for the ones compiled now; raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{report}")
            continue
        os.replace(tmp, lib)
        reports[name] = report
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it if needed."""
    lib = _lib_path(name)
    if not lib.exists():
        build_all((name,))
    return ctypes.CDLL(str(lib))
