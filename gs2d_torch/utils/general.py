"""LR schedules (reference ``utils/general_utils.py``; counterpart of
``gs2d_tpu/utils/general.py``)."""

from __future__ import annotations

import math

import torch


def expon_lr(step, lr_init: float, lr_final: float,
             lr_delay_steps: int = 0, lr_delay_mult: float = 1.0,
             max_steps: int = 1_000_000) -> float:
    """Log-linear LR decay with optional sine-ramped delay.

    Contract of the reference's ``get_expon_lr_func`` (the JaxNeRF
    schedule); returns 0 when disabled. Evaluated in float32, as the JAX
    package traces it, and returned as a Python float."""
    if lr_init == 0.0 and lr_final == 0.0:
        return 0.0
    f32 = torch.float32
    step = torch.tensor(float(step), dtype=f32)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0.0, 1.0))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0.0, 1.0)
    log_init = torch.tensor(math.log(max(lr_init, 1e-30)), dtype=f32)
    log_final = torch.tensor(math.log(max(lr_final, 1e-30)), dtype=f32)
    log_lerp = torch.exp(log_init * (1 - t) + log_final * t)
    if not (float(step) >= 0 and (lr_init > 0 or lr_final > 0)):
        return 0.0
    return float(delay_rate * log_lerp)
