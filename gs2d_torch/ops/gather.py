"""Row gather ``out = table[idx]``: the CUDA kernel's wrapper and its plain
version.

``gather_rows`` replaces the five TPU probes of this function (G1–G5:
``scripts/probe_gather_kernel.py`` ``lane_gather``, ``sub_gather``,
``onehot_gather``; ``scripts/probe_gather_kernel2.py`` ``lane_gather``,
``sub_gather``) with one kernel on the row-major layout,
``gs2d_torch/csrc/gather_rows.cu``. Densification selects the rows of
every parameter and Adam moment through it (``models/densify.py``).

On a CPU tensor the wrapper runs ``gather_rows_reference``; on a CUDA
tensor it launches the kernel or raises. Indices follow torch indexing:
negative ones count from the end, and one outside [-N, N) raises
``IndexError`` (never clamped).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import cuda_build


def _check_inputs(table: torch.Tensor, idx: torch.Tensor):
    if table.dtype != torch.float32 or table.dim() != 2 \
            or not table.is_contiguous():
        raise ValueError(f"table must be a contiguous (N, F) float32 tensor, "
                         f"got {tuple(table.shape)} {table.dtype}")
    if table.shape[1] < 1:
        raise ValueError("table must have at least one column")
    if idx.dtype not in (torch.int32, torch.int64) or idx.dim() != 1:
        raise ValueError(f"idx must be (M,) int32 or int64, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    if idx.device != table.device:
        raise ValueError(f"idx is on {idx.device}, table on {table.device}")


@functools.cache
def _kernel():
    """The C entry point of csrc/gather_rows.cu, built at first use."""
    fn = cuda_build.load("gather_rows").gs2d_gather_rows
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a contiguous (N, F) float32 ``table`` and (M,)
    int32 or int64 ``idx`` (M may be 0) → (M, F) float32."""
    _check_inputs(table, idx)
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cuda or cpu tensors, got "
                         f"{table.device}")
    n, f = table.shape
    m = idx.shape[0]
    out = torch.empty((m, f), dtype=torch.float32, device=table.device)
    if m == 0:
        return out
    bad = torch.zeros(1, dtype=torch.int32, device=table.device)
    launch(table, idx.contiguous(), out, bad)
    if int(bad.item()):
        raise IndexError(f"gather_rows: an index is out of bounds for a "
                         f"table of {n} rows")
    return out


gather_rows.launches = 0   # kernel launches since the last reset


def launch(table: torch.Tensor, idx: torch.Tensor, out: torch.Tensor,
           bad: torch.Tensor) -> None:
    """One launch of the kernel on CUDA tensors that ``gather_rows`` has
    checked: contiguous ``idx`` (M,) with M > 0, ``out`` (M, F) float32,
    ``bad`` one int32, left at 1 if an index is out of range. Neither
    allocates nor waits for the card; ``gather_rows`` is the entry point,
    and this is also what a timing of the kernel alone calls."""
    n, f = table.shape
    if f >= 2 ** 31:
        raise ValueError("gather_rows takes fewer than 2^31 columns")
    vec4 = (f % 4 == 0 and table.data_ptr() % 16 == 0
            and out.data_ptr() % 16 == 0)
    fn = _kernel()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = fn(table.data_ptr(), idx.data_ptr(),
                 int(idx.dtype == torch.int64), n, idx.shape[0], f,
                 int(vec4), out.data_ptr(), bad.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error "
                           f"{err}")
    gather_rows.launches += 1


def gather_rows_reference(table: torch.Tensor,
                          idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gather_rows``."""
    return table[idx.long()]
