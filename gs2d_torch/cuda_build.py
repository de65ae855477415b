"""Build the package's hand-written CUDA kernels and host libraries and
load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface; ``nvcc`` compiles it into
``build/gs2d_torch/lib<name>-<hash>.so`` beside the package at first use
(the hash covers the source, every ``csrc/*.cuh`` header and the flags, so
an edit to any of them rebuilds). Each ``csrc/<name>.cpp`` of
``HOST_LIBS`` is host code with a plain C interface, built the same way by
the host compiler (``c++``, the one ``nvcc`` calls), so it builds on
machines without a card too. Nothing is compiled when a module is
imported: the CPU tests import every module on machines without ``nvcc``.
A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

KERNELS = ("rasterize_fwd", "rasterize_bwd", "gather_rows", "preprocess_fwd",
           "preprocess_bwd")
HOST_LIBS = ("jpeg_entropy",)

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "gs2d_torch"
# -fmad=false keeps one rounding per operation, as the plain PyTorch
# versions round, so per-pixel decisions agree bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _cxx() -> str:
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("c++ not found: the host libraries need a C++ "
                           "compiler on PATH")
    return cxx


def _source(name: str) -> Path:
    return SRC_DIR / (f"{name}.cpp" if name in HOST_LIBS else f"{name}.cu")


def _command(name: str, out: Path) -> list:
    if name in HOST_LIBS:
        return [_cxx(), *CXX_FLAGS, "-o", str(out), str(_source(name))]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(_source(name))]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(_source(name).read_bytes())
    if name in HOST_LIBS:
        h.update(" ".join(CXX_FLAGS).encode())
    else:
        for header in sorted(SRC_DIR.glob("*.cuh")):
            h.update(header.name.encode() + b"\0" + header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names=KERNELS) -> dict:
    """Compile every library of ``names`` not yet built (kernels and
    ``HOST_LIBS`` alike), one compiler per source, all started together.
    Returns {name: compiler report} (for a kernel, ``ptxas -v`` register
    and shared-memory use) for the ones compiled now, and keeps
    each report beside its library (``compiler_report``); raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(_command(name, tmp),
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{report}")
            continue
        lib.with_suffix(".txt").write_text(report)
        os.replace(tmp, lib)
        reports[name] = report
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return reports


def compiler_report(name: str) -> str:
    """The ``nvcc`` output (``ptxas -v``) of kernel ``name``'s built
    library, building it if needed ("" for a library built without one)."""
    lib = _lib_path(name)
    if not lib.exists():
        build_all((name,))
    report = lib.with_suffix(".txt")
    return report.read_text() if report.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name`` (a kernel or a host library), building it
    if needed."""
    lib = _lib_path(name)
    if not lib.exists():
        build_all((name,))
    return ctypes.CDLL(str(lib))
