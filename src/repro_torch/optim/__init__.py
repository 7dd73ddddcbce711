"""Optimizers, schedules and gradient compression: AdamW over named
tensors, the learning-rate schedules and the int8 wire format of
``compression`` (the port of ``repro.optim``)."""
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm)
from repro_torch.optim.compression import compress_int8, decompress_int8
from repro_torch.optim.schedule import cosine_schedule, wsd_schedule

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_int8", "cosine_schedule", "decompress_int8",
           "wsd_schedule"]
