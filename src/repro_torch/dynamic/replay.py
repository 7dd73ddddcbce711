"""Replay helpers: drive a ``DynamicForest`` from an ``EdgeStream``.

The port of ``repro.dynamic.replay``, shared by the tests and
``chip_smoke.py`` so they all apply batches identically: deletions resolve
(u, v) pairs to pool slots through ``edge_slots``, then one
``apply_batch`` call per batch.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.graph import resolve_device
from repro_torch.data.streams import EdgeStream, StreamBatch
from repro_torch.dynamic.forest import (DynamicForest, apply_batch,
                                        edge_slots, forest_empty)


def stream_capacity(stream: EdgeStream, slack: int = 0) -> int:
    """Pool capacity that fits the stream's peak live-edge count."""
    n = stream.n_nodes
    live = int(stream.init_u.shape[0])
    peak = live
    for b in stream.batches:
        live += int((b.ins_u < n).sum()) - int((b.del_u < n).sum())
        peak = max(peak, live)
    return max(peak + slack, 1)


def init_state(stream: EdgeStream, capacity: int | None = None, *,
               device: str | torch.device | None = None,
               use_kernel: bool | None = None) -> DynamicForest:
    """Seed state holding the stream's initially-live edges, on ``device``
    (the card unless the caller names another)."""
    dev = resolve_device(device)
    if capacity is None:
        capacity = stream_capacity(stream)
    state = forest_empty(stream.n_nodes, capacity, device=dev)
    if stream.init_u.shape[0]:
        no_del = torch.zeros(capacity, dtype=torch.bool, device=dev)
        state, _ = apply_batch(state, torch.from_numpy(stream.init_u).to(dev),
                               torch.from_numpy(stream.init_v).to(dev),
                               no_del, use_kernel=use_kernel)
    return state


def replay_batch(state: DynamicForest, b: StreamBatch, **kwargs):
    """Apply one stream batch: resolve deletions, then ``apply_batch``.

    Returns (state', stats); stats gains ``deletes_found`` (0-d int32, the
    delete requests that matched a live pool slot). ``kwargs`` go to
    ``apply_batch``. Records ``rounds + 1`` syncs (the link rounds plus the
    final convergence check, the table4 accounting) to the ``obs`` ledger
    as phase ``apply``.
    """
    dev = state.device
    dmask, found = edge_slots(state, torch.from_numpy(b.del_u).to(dev),
                              torch.from_numpy(b.del_v).to(dev))
    state, stats = apply_batch(state, torch.from_numpy(b.ins_u).to(dev),
                               torch.from_numpy(b.ins_v).to(dev), dmask,
                               **kwargs)
    stats["deletes_found"] = torch.sum(found, dtype=torch.int32)
    obs.record("apply", stats["rounds"] + 1)
    return state, stats
