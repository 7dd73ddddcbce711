"""Euler-tour rooting of a spanning forest (paper §III-D).

The port of ``repro.core.euler``. Given an unrooted spanning forest as an
edge list, orient every edge toward a chosen root per component:

  1. both directions of every forest edge, ``rev(e) = (e + T) % 2T``;
  2. a stable sort of the directed edges by (from, to) — one packed int64
     key, since torch has no ``lexsort`` — which gives the circular
     adjacency order;
  3. the Euler successor ``succ(e) = next(rev(e))``, or
     ``first(from(rev(e)))`` when ``rev(e)`` is its vertex's last edge;
  4. each component's cycle cut into a list at that component's root;
  5. Wyllie list ranking (``compress.wyllie_rank``, list_rank kernel on
     the card), keeping ``d[e]`` = #edges after e;
  6. the earlier direction of each edge is the discovery edge (x → y), so
     ``parent[y] = x``.

Padding slots carry ``from = to = n`` and sort to the tail. Every gather
that the reference leaves to JAX's clamping is clamped or masked here, and
every ``mode="drop"`` scatter writes into an extra slot that is cut off.

``tour_numbering`` gives the tour's dense preorder and subtree sizes for an
already-rooted parent array (DESIGN.md §4).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.compress import NO_SUCC, roots_of, wyllie_rank
from repro_torch.core.graph import resolve_device

INT32_MIN = torch.iinfo(torch.int32).min


def _lexsort_edges(frm: torch.Tensor, to: torch.Tensor, n: int
                   ) -> torch.Tensor:
    """Stable sort of directed edges by (from, to) over ids in [0, n];
    returns the int32 permutation. Equal keys (the padding slots) keep
    their index order, as ``jnp.lexsort`` does."""
    key = frm.long() * (n + 1) + to.long()
    return torch.sort(key, stable=True).indices.to(torch.int32)


def list_rank_dist_to_end(succ: torch.Tensor, valid: torch.Tensor, *,
                          use_kernel: bool | None = None,
                          return_syncs: bool = False):
    """Wyllie list ranking: d[e] = number of list elements after e."""
    return wyllie_rank(succ, valid, use_kernel=use_kernel,
                       return_syncs=return_syncs)


def _tour_successors(n: int, fu: torch.Tensor, fv: torch.Tensor,
                     valid: torch.Tensor, comp_root: torch.Tensor):
    """Steps 1–4 shared by rooting and numbering: build the Euler lists.

    Returns ``(succ, dvalid)`` over the 2T directed slots (slot e < T is
    fu[e]→fv[e], slot e + T its reverse): the −1-terminated successor
    lists, one per component, each cut at its ``comp_root``.
    """
    dev = fu.device
    t = fu.numel()
    fu = torch.where(valid, fu, n)
    fv = torch.where(valid, fv, n)

    frm = torch.cat([fu, fv])
    to = torch.cat([fv, fu])
    m2 = 2 * t
    eid = torch.arange(m2, dtype=torch.int32, device=dev)
    rev = (eid + t) % m2
    dvalid = torch.cat([valid, valid])

    order = _lexsort_edges(frm, to, n)
    order64 = order.long()
    ipos = torch.empty(m2, dtype=torch.int32, device=dev)
    ipos[order64] = eid
    sfrom = frm[order64]
    vert_ids = torch.arange(n + 1, dtype=torch.int32, device=dev)
    first_pos = torch.searchsorted(sfrom, vert_ids, out_int32=True)
    last_pos = torch.searchsorted(sfrom, vert_ids, right=True,
                                  out_int32=True) - 1

    # succ(e) = next(rev(e)), or wrap to first(from(rev(e))).
    p = ipos[rev]
    p_next = torch.clamp(p + 1, max=m2 - 1)
    has_next = (p + 1 < m2) & (sfrom[p_next] == sfrom[p])
    wrap_pos = first_pos[torch.clamp(sfrom[p], 0, n)]
    wrap = order[torch.clamp(wrap_pos, max=m2 - 1)]
    succ = torch.where(has_next, order[p_next], wrap)
    succ = torch.where(dvalid, succ, NO_SUCC)

    # Break each component's cycle at its root: cut rev(last-out-edge(root)).
    verts = vert_ids[:n]
    has_out = last_pos[:-1] >= first_pos[:-1]
    do_cut = (comp_root == verts) & has_out
    last_edge = order[torch.clamp(last_pos[:-1], 0, m2 - 1)]
    cut_idx = torch.where(do_cut, rev[last_edge], m2)
    succ = torch.cat([succ, succ.new_full((1,), NO_SUCC)])
    succ.index_fill_(0, cut_idx.long(), NO_SUCC)
    return succ[:m2], dvalid


@obs.spanned("euler.root")
def euler_tour_root(n_nodes: int, fu: torch.Tensor, fv: torch.Tensor,
                    valid: torch.Tensor, comp_root: torch.Tensor, *,
                    use_kernel: bool | None = None,
                    return_syncs: bool = False):
    """Root a spanning forest by Euler tour.

    Args:
      n_nodes: number of vertices n.
      fu, fv: int32[T] forest edge endpoints (T slots, typically n-1);
              padding slots carry ``fu == fv == n_nodes``.
      valid: bool[T] slot validity.
      comp_root: int32[n], the vertex each component is rooted at
              (``comp_root[v] == v`` iff v is its component's root).
      use_kernel: list ranking through the list_rank kernel (see
              ``repro_torch.kernels.kernel_wanted``).
      return_syncs: also return the list-ranking convergence checks.

    Returns:
      parent: int32[n]; roots and isolated vertices point at themselves.
      With ``return_syncs``: ``(parent, syncs)``.
    """
    n = n_nodes
    t = fu.numel()
    succ, dvalid = _tour_successors(n, fu, fv, valid, comp_root)

    # Rank; the earlier-traversed direction has the larger distance-to-end.
    d, rank_syncs = list_rank_dist_to_end(succ, dvalid, use_kernel=use_kernel,
                                          return_syncs=True)

    # Discovery edge (x → y) ⇒ parent[y] = x; slot n takes the padding.
    disc_u_to_v = d[:t] > d[t:]
    child = torch.where(valid, torch.where(disc_u_to_v, fv, fu), n)
    par = torch.where(disc_u_to_v, fu, fv)
    parent = torch.arange(n + 1, dtype=torch.int32, device=fu.device)
    parent[child.long()] = par
    parent = parent[:n]
    return (parent, rank_syncs) if return_syncs else parent


@dataclasses.dataclass(frozen=True)
class TourNumbering:
    """Euler-tour first/last-visit numbering of a rooted forest.

    Attributes (all int32[n], DESIGN.md §4):
      pre:    dense preorder; subtree(v) is ``[pre[v], pre[v] + size[v])``.
      size:   |subtree(v)| including v.
      last:   ``pre[v] + size[v] - 1``.
      comp:   component root of every vertex (``comp[v] == v`` iff root).
      parent: the parent table the numbering was built from, with negative
              entries replaced by self-loops.
    """

    pre: torch.Tensor
    size: torch.Tensor
    last: torch.Tensor
    comp: torch.Tensor
    parent: torch.Tensor

    @staticmethod
    def from_reference_arrays(pre, size, last, comp, parent,
                              device=None) -> "TourNumbering":
        """Rebuild a numbering from another implementation's arrays (for
        example ``np.asarray`` of each field of ``repro``'s numbering)."""
        dev = resolve_device(device)
        return TourNumbering(*(_int32(a, dev)
                               for a in (pre, size, last, comp, parent)))


def _int32(a, device: torch.device) -> torch.Tensor:
    """An int32 tensor on ``device`` from an array-like."""
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(device)


def tour_numbering(parent: torch.Tensor, *, use_kernel: bool | None = None,
                   return_syncs: bool = False, lanes: int | None = None):
    """First/last-visit numbering of a rooted forest's Euler tour.

    Ranks the 2n directed tree-edge slots once (slot v is the closing edge
    v→parent, slot n + v the discovery edge parent→v); the discovery order
    is the preorder and ``size[v] = (d_down − d_up + 1) / 2``.

    Args:
      parent: int32[n]; roots self-point, negative entries are singletons.
      use_kernel: both the root compression and the list ranking.
      return_syncs: also return root-compression + list-ranking checks.
      lanes: T equal lanes of a disjoint union (see ``core.compress``):
        the numbering sorts by component first, so lane t's numbering is
        its own plus t·L, and ``syncs`` is int32[T], each lane's own.

    Returns:
      TourNumbering, or ``(numbering, syncs)``.
    """
    n = parent.numel()
    dev = parent.device
    verts = torch.arange(n, dtype=torch.int32, device=dev)
    par = torch.where(parent < 0, verts, parent.to(torch.int32))
    nonroot = par != verts
    comp, root_syncs = roots_of(par, use_kernel=use_kernel, return_syncs=True,
                                lanes=lanes)

    fu = torch.where(nonroot, verts, n)
    fv = torch.where(nonroot, par, n)
    succ, dvalid = _tour_successors(n, fu, fv, nonroot, comp)
    d, rank_syncs = wyllie_rank(succ, dvalid, use_kernel=use_kernel,
                                return_syncs=True,
                                lanes=None if lanes is None else 2 * lanes)
    if lanes is not None:
        # The 2n slots are the n closing edges, then the n discovery ones:
        # each lane's count is the larger of its two halves' counts, since
        # a lane's open lists open both.
        rank_syncs = torch.maximum(rank_syncs[:lanes], rank_syncs[lanes:])
    d_up, d_down = d[:n], d[n:]

    # Dense preorder: sort by (component, discovery position); earlier
    # discovery = larger distance-to-end, and roots sort first in their
    # block. Packed as comp·2^32 + (key − INT32_MIN), key ∈ [INT32_MIN, 0].
    key = torch.where(nonroot, -d_down, INT32_MIN)
    packed = (comp.long() << 32) + (key.long() - INT32_MIN)
    order = torch.sort(packed, stable=True).indices
    pre = torch.empty(n, dtype=torch.int32, device=dev)
    pre[order] = verts

    # A root's size is its component's vertex count, read off ``comp`` in
    # preorder, which is sorted. (A histogram of ``comp`` gives the same,
    # but on a connected graph all its n atomics land on one bin.)
    comp_sorted = comp[order]
    comp_size = (torch.searchsorted(comp_sorted, verts, right=True,
                                    out_int32=True)
                 - torch.searchsorted(comp_sorted, verts, out_int32=True))
    size = torch.where(nonroot, (d_down - d_up + 1) // 2, comp_size)

    tn = TourNumbering(pre=pre, size=size, last=pre + size - 1, comp=comp,
                       parent=par)
    return (tn, root_syncs + rank_syncs) if return_syncs else tn
