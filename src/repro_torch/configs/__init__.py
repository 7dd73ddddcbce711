"""Architecture registry: ``get_arch(arch_id)`` → ArchSpec.

The port's own copy of ``repro.configs``: the same ids and the recsys
shape table. Only ``dien`` is ported; ``get_arch`` raises
``NotImplementedError`` for the other ids (ROADMAP §1 item 15).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable

ARCH_IDS = (
    "minicpm-2b", "llama3.2-1b", "qwen3-1.7b", "moonshot-v1-16b-a3b",
    "dbrx-132b",
    "dimenet", "schnet", "meshgraphnet", "gat-cora",
    "dien",
)

_MODULES = {"dien": "dien"}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # "lm" | "gnn" | "recsys"
    make_config: Callable[[], Any]    # full (assigned) config
    make_smoke_config: Callable[[], Any]
    shapes: dict                      # shape_name → cell descriptor


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (ROADMAP §1 item 15); "
            f"ported: {tuple(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.get()


RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1000448),
}
