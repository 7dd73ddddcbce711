"""The pass plan of the two chain kernels (``pointer_jump_k``, ``list_rank_k``).

A chain call of k steps computes T^(k+1), k + 1 hops of the map T (the
parent table, or list ranking's (succ, dist) step) against one fixed
snapshot. Powers of one map commute, so T^(k+1) can be composed from
squarings: T^2 = T∘T, T^4 = T^2∘T^2, and so on. The kernels run it as
passes over the whole table, a grid-wide barrier between them. A pass maps
entry i through a short sequence of tables: its first table is read at i
(a coalesced read), every further one is a random gather at the entry
reached so far. Pass j writes table j; table 0 is the input T.

``hop_schedule(k)`` gives the passes as tuples of table indices. It picks
the plan with the fewest gathers an element (``k`` for the one-pass chain,
3 at k = 5, 5 at k = 31), then the fewest passes, then the fewest gathers
from the input (so T^2 comes before T^3 at k = 5). Up to ``SEARCH_HOPS``
hops the plan comes from an exhaustive search; above, it is
square-and-multiply, whose last pass takes the top bit as two halves and
every lower set bit. List ranking asks for ``pack_input``: a first pass
copies its two int32 inputs into one packed table, so that every gather
after it fetches one sector, not two.
"""
from __future__ import annotations

import ctypes
import functools

# Plans up to this many hops are searched (the cost of the addition-chain
# search grows steeply past 2^6 hops, and the tests replay every one).
SEARCH_HOPS = 65


@functools.lru_cache(maxsize=None)
def hop_schedule(n_steps: int,
                 pack_input: bool = False) -> tuple[tuple[int, ...], ...]:
    """The passes that compose ``max(n_steps, 0) + 1`` hops.

    Each pass is a tuple of table indices: 0 the input, j >= 1 the table
    pass j wrote (so every index is below the pass's own number). The last
    pass writes the result. ``n_steps <= 0`` gives ``((0,),)``: one pass
    that copies the input, with no gather. With ``pack_input``, a plan that
    gathers starts with a pass ``(0,)`` that copies the input into table 1,
    and reads table 1 wherever it read the input.
    """
    hops = max(n_steps, 0) + 1
    if hops == 1:
        return ((0,),)
    plan = _as_tables(_searched(hops) if hops <= SEARCH_HOPS
                      else _square_and_multiply(hops))
    if pack_input:
        plan = ((0,),) + tuple(tuple(t + 1 for t in p) for p in plan)
    return plan


@functools.lru_cache(maxsize=None)
def c_schedule(plan: tuple[tuple[int, ...], ...]) -> ctypes.Array:
    """``plan`` as the kernels' C entries take it: an int32 array holding
    each pass as its term count, then its tables."""
    flat = [x for p in plan for x in (len(p), *p)]
    return (ctypes.c_int32 * len(flat))(*flat)


def gathers(schedule) -> int:
    """Random gathers an element makes under ``schedule``."""
    return sum(len(p) - 1 for p in schedule)


def _searched(hops: int) -> tuple[tuple[int, ...], ...]:
    """The best plan as passes of exponents (each pass's terms sum to the
    exponent of the table it writes), by iterative deepening on gathers.

    WLOG each pass writes a larger exponent than any before it (each term
    is smaller than the sum), so a state is the ascending tuple of
    exponents written so far.
    """

    @functools.lru_cache(maxsize=None)
    def best(kept: tuple[int, ...], budget: int):
        top = kept[-1]
        if top << budget < hops:  # each gather at most doubles the top
            return None
        found = None
        for terms in _multisets(kept, budget + 1, hops):
            if sum(terms) <= top:
                continue
            input_gathers = max(terms.count(1) - 1, 0)
            if sum(terms) == hops:
                cand = (1, input_gathers, (terms,))
            else:
                rest = best(kept + (sum(terms),), budget - len(terms) + 1)
                if rest is None:
                    continue
                cand = (rest[0] + 1, rest[1] + input_gathers,
                        (terms,) + rest[2])
            if found is None or cand[:2] < found[:2]:
                found = cand
        return found

    budget = (hops - 1).bit_length()
    while (found := best((1,), budget)) is None:
        budget += 1
    return found[2]


def _multisets(kept, max_terms: int, limit: int, prefix=()):
    """Non-increasing tuples of 2..max_terms values of ``kept`` summing to
    at most ``limit``, each extending ``prefix``."""
    start = kept.index(prefix[-1]) if prefix else len(kept) - 1
    for j in range(start, -1, -1):
        terms = prefix + (kept[j],)
        if sum(terms) > limit:
            continue
        if len(terms) >= 2:
            yield terms
        if len(terms) < max_terms:
            yield from _multisets(kept, max_terms, limit, terms)


def _square_and_multiply(hops: int) -> tuple[tuple[int, ...], ...]:
    """Squarings up to half the top bit of ``hops``, then one pass of the
    two halves and every lower set bit."""
    top = hops.bit_length() - 1
    plan = [(1 << (q - 1),) * 2 for q in range(1, top)]
    low = tuple(1 << q for q in range(top) if hops >> q & 1)
    return tuple(plan) + ((1 << (top - 1),) * 2 + low,)


def _as_tables(plan) -> tuple[tuple[int, ...], ...]:
    """Exponents to table indices, the input's terms first (a coalesced
    read where the pass has one)."""
    index = {1: 0}
    out = []
    for j, terms in enumerate(plan, start=1):
        out.append(tuple(sorted((index[e] for e in terms),
                                key=lambda t: t != 0)))
        index.setdefault(sum(terms), j)
    return tuple(out)
