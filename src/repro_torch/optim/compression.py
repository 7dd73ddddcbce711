"""int8 gradient compression with error feedback (cross-pod wire format).

The port of ``repro.optim.compression``, in torch ops. The cross-pod
gradient all-reduce is the slowest collective on the 2-pod mesh;
compressing its payload 4× (float32 → int8 with one float32 scale per
block of ``BLOCK`` values) with an error-feedback residual keeps
convergence intact (1-bit Adam lineage).

``torch.round`` rounds half to even, as ``jnp.round`` does. The scale is
``max |block| / 127`` and the quotient ``block / scale``, both true
IEEE divisions by a tensor on the CPU and on the card alike, so the two
devices agree to the bit; where XLA's CPU division lands one ulp away, a
quotient at a .5 tie rounds one int8 step apart.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def compress_int8(x: torch.Tensor):
    """x: float tensor → (int8 payload [blocks, BLOCK], per-block float32
    scales [blocks, 1], pad)."""
    flat = x.reshape(-1).float()
    pad = -flat.numel() % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.view(-1, BLOCK)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # A tensor divisor: on the card torch turns division by a Python
    # scalar into a multiplication by its reciprocal, one ulp off.
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(blocks / torch.clamp_min(scale, 1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale, pad


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, pad: int, shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def compress_with_error_feedback(grad: torch.Tensor, residual: torch.Tensor):
    """Returns (the gradient after an int8 round trip, in its dtype; the new
    float32 residual)."""
    g = grad.float() + residual
    q, s, pad = compress_int8(g)
    deq = decompress_int8(q, s, pad, g.shape)
    return deq.to(grad.dtype), g - deq
