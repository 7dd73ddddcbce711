"""AdamW with float32 master weights and moments, over named tensors.

The port of ``repro.optim.adamw``. Parameters, gradients and every part of
the state are dicts keyed by parameter name, in the order of
``dict(module.named_parameters())``. The state keeps the reference's layout, ``{"m", "v", "master",
"step"}``: float32 moments and master copy per name, and an int32 0-d step
count. The update is the reference's, in its order: gradients clipped to a
global norm first, bias corrections from ``step + 1``, and decoupled weight
decay on every tensor (tables and biases too). Nothing is updated in place:
each call returns new tensors.

Leaves may be DTensors (a sharded train step): the state keeps each
parameter's placement, the step is a plain 0-d tensor (replicated), and
the global norm adds each leaf's sum of squares reduced to a replicated
scalar first, so every rank scales by the same norm.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import replicated


def adamw_init(params: dict[str, torch.Tensor]) -> dict:
    """Zero moments, a float32 master copy of each parameter, step 0.
    Each moment is placed as its parameter."""
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32,
                                      memory_format=torch.contiguous_format)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32,
                                      memory_format=torch.contiguous_format)
                  for k, p in params.items()},
            "master": {k: p.detach().to(torch.float32, copy=True)
                       for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def clip_by_global_norm(grads: dict[str, torch.Tensor], max_norm: float):
    """(grads scaled so that their global float32 norm is at most
    ``max_norm``, the norm before scaling). The squares are summed tensor
    by tensor in the dict's order; a DTensor's sum is first reduced to a
    replicated plain scalar."""
    gn = torch.sqrt(sum(replicated(torch.sum(torch.square(g.float())))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(grads: dict[str, torch.Tensor], opt_state: dict, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_norm: float | None = 1.0,
                 compute_dtype: torch.dtype = torch.bfloat16):
    """Returns (new parameters in ``compute_dtype``, new state, the
    gradients' global norm before clipping; 0 with ``max_norm=None``).

    ``lr`` is a float or a 0-d float32 tensor (a schedule's value at the
    state's step before this update).
    """
    step_t = opt_state["step"]
    if max_norm is not None:
        grads, gn = clip_by_global_norm(grads, max_norm)
    else:
        gn = torch.zeros((), device=step_t.device)
    step = step_t + 1
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    new_m, new_v, new_master = {}, {}, {}
    for k, g in grads.items():
        g = g.float()
        m = b1 * opt_state["m"][k] + (1 - b1) * g
        v = b2 * opt_state["v"][k] + (1 - b2) * g * g
        master = opt_state["master"][k]
        mhat = m / c1
        vhat = v / c2
        new_m[k], new_v[k] = m, v
        new_master[k] = master - lr * (mhat / (torch.sqrt(vhat) + eps)
                                       + weight_decay * master)
    new_params = {k: p.to(compute_dtype) for k, p in new_master.items()}
    return new_params, {"m": new_m, "v": new_v, "master": new_master,
                        "step": step}, gn
