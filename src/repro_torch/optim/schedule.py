"""Learning-rate schedules: WSD (MiniCPM's Warmup-Stable-Decay) and cosine.

The port of ``repro.optim.schedule``. Each is a function of an integer step
(an int or a 0-d integer tensor, which may lie on the card) and returns a
0-d float32 tensor on the step's device, computed in float32 in the
reference's order of operations.
"""
from __future__ import annotations

import math

import torch


def _float_step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def wsd_schedule(step, *, peak_lr: float, warmup: int, stable: int,
                 decay: int, final_frac: float = 0.1) -> torch.Tensor:
    """Warmup-Stable-Decay  [arXiv:2404.06395 §4].

    Linear warmup → constant plateau → linear decay to final_frac · peak
    over the decay window.
    """
    s = _float_step(step)
    warm = peak_lr * s / max(warmup, 1)
    stab = torch.full_like(s, peak_lr)
    t = torch.clamp((s - warmup - stable) / max(decay, 1), 0.0, 1.0)
    dec = peak_lr * (1.0 - (1.0 - final_frac) * t)
    return torch.where(s < warmup, warm,
                       torch.where(s < warmup + stable, stab, dec))


def cosine_schedule(step, *, peak_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup, then a cosine from peak_lr down to final_frac · peak
    at ``total``, flat after it."""
    s = _float_step(step)
    warm = peak_lr * s / max(warmup, 1)
    t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warmup, warm, peak_lr * cos)
