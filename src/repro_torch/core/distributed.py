"""Multi-rank rooted spanning forest: the paper's algorithm over a mesh.

The port of ``repro.core.distributed``. The hooking / pointer-jumping
rounds of ``core.connectivity`` spread over one axis of a
``DeviceMesh`` with explicit ``torch.distributed`` collectives:

  * **edges are sharded** over the axis: each rank takes its contiguous
    block of the global half-edge arrays, as ``P(axis)`` places them;
  * **the parent table is replicated** (O(V) a rank): each rank's hook
    proposals are combined with an elementwise all-reduce-min
    (``dist.all_reduce(op=MIN)`` over ``mesh.get_group(axis)``), the
    multi-rank analogue of the single-card atomicMin;
  * pointer jumping is local (``compress_full`` on the replicated table;
    on the card its ``pointer_jump_double`` kernel), so a round costs two
    all-reduce-min calls of n int32 each (hook, winner edge), whatever the
    graph's diameter.

Mesh dims other than ``axis`` hold replicas and join no collective. The
round loop is a host loop that reads ``changed`` once a round, under the
reference's bound (``rounds < n``); ``rounds`` is a host int, the rounds
run minus one. ``forest_mask`` is gathered once after the loop.

As in ``core.connectivity``, the hook scatters send inactive writers into
n drop slots spread by edge id (cut off before the all-reduce), where the
reference writes its identity into real slots: the same minima, without
every non-crossing edge of a hub queueing on one address.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.compress import compress_full
from repro_torch.distributed.sharding import Sharded, ns

INF32 = torch.iinfo(torch.int32).max


def _allmin(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise min across the group's ranks, in place."""
    dist.all_reduce(x, op=dist.ReduceOp.MIN, group=group)
    return x


def _gather_blocks(local: torch.Tensor, group, world: int,
                   rank: int) -> torch.Tensor:
    """The group's equal 1-D blocks concatenated in rank order. gloo has no
    all-gather for CUDA tensors: there each rank writes its block into a
    zero buffer and one all-reduce sums them."""
    if world == 1:
        return local
    if dist.get_backend(group) == "gloo" and local.is_cuda:
        out = torch.zeros(world * local.numel(), dtype=local.dtype,
                          device=local.device)
        out[rank * local.numel():(rank + 1) * local.numel()] = local
        dist.all_reduce(out, group=group)
        return out
    out = torch.empty(world * local.numel(), dtype=local.dtype,
                      device=local.device)
    dist.all_gather_into_tensor(out, local, group=group)
    return out


def distributed_cc_spanning_forest(mesh, axis: str = "data", *,
                                   use_kernel: bool | None = None):
    """Build the sharded connectivity + spanning-forest function.

    Returns ``run(src, dst, *, n_nodes, return_syncs=False) -> (rep,
    forest_mask, rounds[, syncs])``. Every rank passes the GLOBAL int32
    half-edge arrays (their length a multiple of the axis size: pad with
    self-loop edges (0, 0)) on its device and takes its own block.
    ``rep`` is int32[n], the same on every rank; ``forest_mask`` bool[m],
    the global mask: True on the half-edge that won its target's hook (the
    smallest global edge id among those that achieved it), n − #components
    set; ``syncs`` the convergence checks of the ``compress_full`` calls,
    summed (the pointer_jump kernel launches once a check). ``use_kernel``
    goes to ``compress_full``.
    """
    names = mesh.mesh_dim_names
    axis_size = mesh.size(names.index(axis))
    group = mesh.get_group(axis)
    shard = mesh.get_local_rank(axis)

    def run(src: torch.Tensor, dst: torch.Tensor, *, n_nodes: int,
            return_syncs: bool = False):
        m = src.shape[0]
        assert m % axis_size == 0, (
            f"edge count {m} must divide mesh axis {axis}={axis_size}; "
            "pad with self-loop edges (0, 0)")
        n = n_nodes
        dev = src.device
        mb = m // axis_size
        lo = shard * mb
        s, d = src[lo:lo + mb], dst[lo:lo + mb]
        gid = torch.arange(lo, lo + mb, dtype=torch.int32, device=dev)
        drop = n + gid.long() % max(n, 1)

        p = torch.arange(n, dtype=torch.int32, device=dev)
        forest = torch.zeros(mb, dtype=torch.bool, device=dev)
        rnd, changed, syncs = 0, True, 0
        while changed and rnd < n:
            ru, rv = p[s], p[d]
            cross = ru != rv
            val = torch.minimum(ru, rv)          # pure min-hooking
            tgt = torch.maximum(ru, rv)
            idx = torch.where(cross, tgt.long(), drop)

            # Local hook proposals, then ONE all-reduce-min.
            hook = torch.full((2 * n,), INF32, dtype=torch.int32, device=dev)
            hook.scatter_reduce_(0, idx, torch.where(cross, val, INF32),
                                 "amin")
            glob = _allmin(hook[:n], group)
            got = glob != INF32
            p_next = torch.where(got, glob, p)

            # Winner edge (global edge id): the second all-reduce-min.
            achieved = cross & got[tgt] & (glob[tgt] == val)
            win = torch.full((2 * n,), INF32, dtype=torch.int32, device=dev)
            win.scatter_reduce_(0, torch.where(achieved, tgt.long(), drop),
                                torch.where(achieved, gid, INF32), "amin")
            glob_win = _allmin(win[:n], group)
            forest |= achieved & (glob_win[tgt] == gid)

            p, k = compress_full(p_next, use_kernel=use_kernel,
                                 return_syncs=True)
            syncs += k
            changed = bool(torch.any(got))
            rnd += 1
        mask = _gather_blocks(forest.to(torch.uint8), group, axis_size,
                              shard).bool()
        if return_syncs:
            return p, mask, rnd - 1, syncs
        return p, mask, rnd - 1

    return run


def input_specs_rst(n_nodes: int, n_half_edges: int, mesh,
                    axis: str = "data") -> dict:
    """The inputs' ``meta`` stand-ins with their sharding (no
    allocation)."""
    del n_nodes
    return {k: Sharded(torch.empty((n_half_edges,), dtype=torch.int32,
                                   device="meta"), ns(mesh, axis))
            for k in ("src", "dst")}
