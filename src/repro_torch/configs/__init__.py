"""Architecture registry: ``get_arch(arch_id)`` → ArchSpec.

The port's own copy of ``repro.configs``: the same ids, the same configs
(an LM's ``dtype`` a torch dtype) and the LM, GNN and recsys shape tables.
``fsdp`` (FSDP parameter sharding of an LM) picks the parameter specs of
``distributed.sharding.lm_param_specs``, by which ``train.step.build_cell``
places a cell's parameters on a mesh (and the dry run reads their
bytes).
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

_MODULES = {
    "minicpm-2b": "minicpm_2b",
    "llama3.2-1b": "llama3_2_1b",
    "qwen3-1.7b": "qwen3_1_7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "dbrx-132b": "dbrx_132b",
    "dimenet": "dimenet",
    "schnet": "schnet",
    "meshgraphnet": "meshgraphnet",
    "gat-cora": "gat_cora",
    "dien": "dien",
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # "lm" | "gnn" | "recsys"
    make_config: Callable[[], Any]    # full (assigned) config
    make_smoke_config: Callable[[], Any]
    shapes: dict                      # shape_name → cell descriptor
    fsdp: bool = False                # LM only: FSDP param sharding
    notes: str = ""


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.get()


LM_SHAPES = {
    "train_4k": dict(kind="train", batch=256, seq=4096),
    "prefill_32k": dict(kind="prefill", batch=32, seq=32768),
    "decode_32k": dict(kind="decode", batch=128, seq=32768),
    # Decode cost is linear in KV length (one query token); the reference
    # runs this cell with a sequence-sharded KV cache.
    "long_500k": dict(kind="decode", batch=1, seq=524288),
}

# GNN cells (padded to multiples of 512 so every mesh divides evenly).
GNN_SHAPES = {
    "full_graph_sm": dict(kind="train", n_nodes=2720, n_edges=10560,
                          d_feat=1433, n_graphs=1,
                          raw=dict(n_nodes=2708, n_edges=10556)),
    "minibatch_lg": dict(kind="train", n_nodes=172032, n_edges=169984,
                         d_feat=602, n_graphs=1, sampled=True,
                         raw=dict(n_nodes=232965, n_edges=114615892,
                                  batch_nodes=1024, fanout=(15, 10))),
    "ogb_products": dict(kind="train", n_nodes=2449408, n_edges=61859840,
                         d_feat=100, n_graphs=1,
                         raw=dict(n_nodes=2449029, n_edges=61859140)),
    "molecule": dict(kind="train", n_nodes=3840, n_edges=8192, d_feat=8,
                     n_graphs=128, raw=dict(n_nodes=30, n_edges=64,
                                            batch=128)),
}

RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1000448),
}
