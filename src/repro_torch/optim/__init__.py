"""Optimizers and schedules: AdamW over named tensors, and the learning-rate
schedules (the port of ``repro.optim``; its int8 gradient compression
belongs to the mesh code, ROADMAP §1 item 15)."""
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "wsd_schedule"]
