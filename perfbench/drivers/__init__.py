"""The traffic mixes' drivers, one module per ``kind`` of a mix's data
file, each with ``run(r: Run) -> Outcome``, and what they share."""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Optional

import torch

from ..readers import Traced


@dataclasses.dataclass
class Run:
    workload: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    mode: str = "run"          # "run", "control" or a fault's name
    n: int = 0                 # the surfel count, 0: the configuration's
    scale: float = 1.0         # the image size's scale (tests)
    t_start: float = 0.0       # the process's start, wall clock

    def log(self, msg: str) -> None:
        print(f"[perfbench {time.time() - self.t_start:8.2f}s] {msg}",
              file=sys.stderr, flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def peak_bytes(self) -> int:
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0


@dataclasses.dataclass
class Outcome:
    metrics: dict              # end-to-end metric → value
    attempted: int
    failed: int
    memory_peak: int
    numbers: dict              # compared number → value
    setup_s: float
    traced: Optional[Traced] = None


class WindowClosed(Exception):
    """Raised from the loop's per-iteration callback to end the run."""


@contextlib.contextmanager
def patched(obj, name: str, value):
    """``obj.name = value`` for the block."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def rel_l1(a: torch.Tensor, b: torch.Tensor) -> float:
    """Σ|a − b| / Σ|b|, in float64."""
    a, b = a.double(), b.double()
    return float(torch.sum(torch.abs(a - b))
                 / torch.clamp(torch.sum(torch.abs(b)), min=1e-300))


def reference_mode() -> None:
    """Plain float32 for the reference: no TF32 in products or
    convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
