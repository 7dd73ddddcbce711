"""Per-card cost and memory of one step, counted as the step runs.

The counterpart of ``repro.launch.hlo_analysis``. The reference compiles
each cell and parses XLA's optimized, SPMD-partitioned HLO text: dot
flops times each while loop's trip count, bytes at fusion boundaries,
collective payloads by opcode. The port has no compiled program to parse:
PyTorch runs the step eagerly, op by op, so the ops it dispatches are the
program. ``CostMode`` is a ``TorchDispatchMode`` that sees each of them
once per execution: a Python loop is counted as often as it runs, so the
reference's trip-count problem (a loop body counted once) does not arise.

It returns ``NotImplemented`` for any op with a ``DTensor`` among its
types, so that DTensor first turns the op into this rank's local ops and
the collectives its redistributions need (the trick of
``torch.distributed.tensor.debug.CommDebugMode``); every number below is
therefore per card, rank 0's, as the reference's partitioned HLO is.
Nothing DTensor runs to infer an op's placements and shapes is counted:
its ops on fake tensors, and every op while its sharding propagator runs
(the propagation through an op's decomposition makes ``meta`` tensors of
the global shape outside any fake mode, which the step never holds).

``OpCost`` holds the reference's fields (``HloCost.to_json``):
  * ``flops``: 2·M·N·K of every ``mm``, ``addmm``, ``bmm`` and ``baddbmm``
    (the formulas of ``torch.utils.flop_counter``'s registry, on the local
    shapes this mode sees) and 2·M·N of ``mv`` / 2·N of ``dot``;
    ``matmul``, ``linear`` and ``einsum`` reach the dispatcher as these;
  * ``bytes_accessed``: operand plus result bytes of every op that moves
    data; views and metadata ops (``view``, ``t``, ``expand``,
    ``as_strided``, ``detach``, ``_unsafe_view``, ``split``, empty
    allocations, waits) count 0, as the reference skips ``bitcast``,
    ``tuple`` and ``get-tuple-element``. In eager mode every op is a
    kernel boundary, so this is the traffic the card's program really
    has, not the reference's fusion-boundary proxy (which is lower);
  * ``collective_bytes`` and ``per_collective``: the payload (operand
    bytes, as ``hlo_analysis.py`` counts it) of every collective, by the
    reference's kind (``COLLECTIVE_OPS``): the functional collectives
    DTensor calls (``_c10d_functional.*``) and the explicit ones of
    ``torch.distributed`` (``c10d.*_``). On a CPU-typed mesh DTensor turns
    a shard-dim all-to-all into an all-gather and a chunk (gloo has no
    all-to-all); it is counted as the all-to-all a CUDA mesh runs, with
    the local shard's bytes.

A hand-written kernel's plain version (the wrapper's path off the card)
is counted as the card's launch, as the reference counts a custom call:
bytes at its boundary (operands and result), no flops (none of them
multiplies matrices), none of its intermediate ops. The wrappers reach
this through ``repro_torch.kernels.plain_as_kernel``.

``memory_analysis`` has the reference's keys, per card:
  * ``argument_size_in_bytes``: the state and inputs (each storage once),
    ``launch.dryrun``'s ``bytes_per_device.total``;
  * ``output_size_in_bytes``: the storages of the step's returned
    tensors;
  * ``alias_size_in_bytes``: the part of those that are argument storages
    (written in place, as the decode step writes its cache);
  * ``temp_size_in_bytes``: the peak, over the step, of the bytes of live
    storages the step allocated: activations, autograd's saved tensors,
    the recomputation under ``torch.utils.checkpoint``, gradients, and
    the outputs live at that moment. Lifetimes are tracked by storage (a
    view adds nothing; a storage is freed when its last tensor goes), so
    ``argument + temp`` is the step's peak memory on the card, before the
    caching allocator's rounding. XLA's temp leaves the outputs out.
  * ``generated_code_size_in_bytes`` has no counterpart (no compiled
    program) and is left out.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

_aten = torch.ops.aten
# Op name (namespace.name) → (kind, index of the payload argument).
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced":
        ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_dtensor.shard_dim_alltoall": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_coalesced_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
}
# Ops that move no data beyond what ``func.is_view`` already catches.
_NO_BYTES = frozenset({
    "aten._unsafe_view", "aten.lift_fresh", "aten.empty", "aten.empty_strided",
    "aten.new_empty", "aten.new_empty_strided", "aten.empty_like",
    "aten.sym_size", "aten.sym_stride", "aten.sym_numel",
    "aten.sym_storage_offset", "aten.is_same_size",
    "_c10d_functional.wait_tensor", "_c10d_functional._wrap_tensor_autograd",
})
#: Ops whose result is their first argument's storage on the card (a
#: wrapper) but a new one on ``meta``: counted as that storage.
_ALIASES = frozenset({"_c10d_functional._wrap_tensor_autograd"})


def _mv_flop(a, x, *args, out_val=None, **kwargs) -> int:
    return 2 * a.shape[0] * a.shape[1]


def _addmv_flop(c, a, x, *args, out_val=None, **kwargs) -> int:
    return _mv_flop(a, x)


def _dot_flop(x, y, *args, out_val=None, **kwargs) -> int:
    return 2 * x.shape[0]


def _product_flops() -> dict:
    """The flop formula of each product op, by its overload packet."""
    from torch.utils.flop_counter import flop_registry
    out = {p: flop_registry[p] for p in (_aten.mm, _aten.addmm, _aten.bmm,
                                         _aten.baddbmm)}
    out.update({_aten.mv: _mv_flop, _aten.addmv: _addmv_flop,
                _aten.dot: _dot_flop})
    return out


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _op_name(func) -> str:
    return f"{func.namespace}.{func._opname}"


@dataclasses.dataclass
class OpCost:
    """One step's per-card counts (``hlo_analysis.HloCost``'s fields)."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    per_collective: dict = dataclasses.field(
        default_factory=lambda: defaultdict(float))

    def to_json(self) -> dict:
        return {"flops": self.flops, "bytes_accessed": self.bytes_accessed,
                "collective_bytes": self.collective_bytes,
                "per_collective": dict(self.per_collective)}


class CostMode(TorchDispatchMode):
    """Counts each local op's flops and bytes, each collective's payload,
    and the peak bytes of live storages allocated while it is active
    (``cost``, ``peak``). ``arguments(tree)`` marks storages that exist
    before the step, which the peak leaves out."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.live = 0
        self.peak = 0
        self._owned: dict[int, int] = {}
        self._args: set[int] = set()
        self._aliased: set[int] = set()
        self._opaque = 0
        self._flops = _product_flops()

    # -- storages ----------------------------------------------------------
    @staticmethod
    def _key(t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def arguments(self, tree) -> int:
        """Mark the storages of ``tree``'s tensors (DTensors by their local
        block) as the step's arguments; returns their bytes."""
        total = 0
        for t in local_tensors(tree):
            key = self._key(t)
            if key not in self._args:
                self._args.add(key)
                total += t.untyped_storage().nbytes()
        return total

    def _free(self, key: int) -> None:
        self.live -= self._owned.pop(key, 0)

    def _allocated(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._owned or key in self._args or key in self._aliased:
                continue
            n = st.nbytes()
            self._owned[key] = n
            self.live += n
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.live)

    def _alias(self, out: torch.Tensor, src: torch.Tensor) -> None:
        """``out``'s storage counted as ``src``'s: not itself, and
        ``src``'s stays live (counted once) for as long as ``out``'s
        does."""
        st = out.untyped_storage()
        key = st._cdata
        if key == src.untyped_storage()._cdata or key in self._owned:
            return
        self._aliased.add(key)
        weakref.finalize(st, self._unalias, key, src.untyped_storage())

    def _unalias(self, key: int, _src) -> None:
        self._aliased.discard(key)

    # -- counting ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if (self._opaque or _shape_propagation(types)
                or isinstance(func, torch._ops.HigherOrderOperator)):
            return out
        name = _op_name(func)
        coll = _COLLECTIVES.get(name)
        if coll is not None:
            kind, at = coll
            payload = sum(tensor_bytes(t) for t in tree_leaves(args[at])
                          if isinstance(t, torch.Tensor))
            self.cost.per_collective[kind] += payload
            self.cost.collective_bytes += payload
        flop = self._flops.get(func._overloadpacket)
        if flop is not None:
            self.cost.flops += flop(*args, **kwargs, out_val=out)
        if not (func.is_view or name in _NO_BYTES):
            self.cost.bytes_accessed += sum(
                tensor_bytes(t) for t in tree_leaves((args, kwargs, out))
                if isinstance(t, torch.Tensor))
        if name in _ALIASES:
            self._alias(out, args[0])
        else:
            self._allocated(out)
        return out

    def propagating(self, fn):
        """``fn`` with every op it runs left uncounted (DTensor's sharding
        propagation: bookkeeping, not the step's work)."""
        def run(*args, **kwargs):
            self._opaque += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self._opaque -= 1
        return run

    def opaque(self, run, inputs, *, collective: str | None = None):
        """``run()`` counted as one launch: its ops uncounted, its inputs
        and result as the bytes moved (and, for ``collective``, the
        inputs as its payload), its result's storages allocated."""
        self._opaque += 1
        try:
            out = run()
        finally:
            self._opaque -= 1
        moved = sum(tensor_bytes(t) for t in tree_leaves(inputs)
                    if isinstance(t, torch.Tensor))
        if collective is not None:
            self.cost.per_collective[collective] += moved
            self.cost.collective_bytes += moved
        self.cost.bytes_accessed += moved + sum(
            tensor_bytes(t) for t in tree_leaves(out)
            if isinstance(t, torch.Tensor))
        self._allocated(out)
        return out


def _shape_propagation(types) -> bool:
    """Whether the op runs under DTensor's shape propagation (fake tensors
    of the global shape): not part of the step's work."""
    return (any(issubclass(t, FakeTensor) for t in types)
            or torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None)


#: The sharding propagator's entry points, outermost first: the op
#: dispatcher's slow path calls ``propagate_op_sharding`` (an LRU cache of
#: ``propagate_op_sharding_non_cached``, bound when the propagator is
#: made, so each is wrapped on the instance), other DTensor code
#: ``propagate``.
_PROPAGATOR_ENTRIES = ("propagate", "propagate_op_sharding",
                       "propagate_op_sharding_non_cached")


@contextlib.contextmanager
def _propagation_uncounted(mode: CostMode):
    """DTensor's sharding propagator with its entry points wrapped so
    that ``mode`` counts none of the ops they run. Raises if it lacks
    ``propagate_op_sharding``: the count would take in DTensor's
    bookkeeping."""
    prop = DTensor._op_dispatcher.sharding_propagator
    names = [n for n in _PROPAGATOR_ENTRIES
             if callable(getattr(prop, n, None))]
    if "propagate_op_sharding" not in names:
        raise RuntimeError("DTensor's sharding propagator has no "
                           "propagate_op_sharding: its ops would be counted")
    own = {n: prop.__dict__[n] for n in names if n in prop.__dict__}
    for n in names:
        setattr(prop, n, mode.propagating(getattr(prop, n)))
    try:
        yield
    finally:
        for n in names:
            if n in own:
                setattr(prop, n, own[n])
            else:
                delattr(prop, n)


def storage_bytes(tree) -> int:
    """The bytes of the storages of ``tree``'s tensors (as
    ``local_tensors`` finds them), each storage once."""
    seen = {}
    for t in local_tensors(tree):
        st = t.untyped_storage()
        seen.setdefault(st._cdata, st.nbytes())
    return sum(seen.values())


def local_tensors(tree):
    """Every plain tensor of ``tree`` (dicts, lists, tuples, modules by
    their parameters), a DTensor by its local block."""
    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from local_tensors(v)
    elif isinstance(tree, DTensor):
        yield tree._local_tensor
    elif isinstance(tree, torch.Tensor):
        yield tree


def _alltoall_sites() -> tuple:
    """DTensor's ``shard_dim_alltoall`` and every DTensor module that calls
    it by name."""
    from torch.distributed.tensor import _collective_utils
    orig = _collective_utils.shard_dim_alltoall
    return orig, [m for name, m in list(sys.modules.items())
                  if name.startswith("torch.distributed.tensor")
                  and getattr(m, "shard_dim_alltoall", None) is orig]


@contextlib.contextmanager
def counting():
    """A ``CostMode`` active for the length of the ``with``: wrappers'
    plain versions count as their kernels, DTensor's CPU fallback for a
    shard-dim all-to-all counts as the all-to-all, and DTensor's sharding
    propagation counts nothing."""
    from repro_torch import kernels
    mode = CostMode()
    orig, sites = _alltoall_sites()

    def alltoall(input, *args, **kwargs):
        return mode.opaque(lambda: orig(input, *args, **kwargs), input,
                           collective="all-to-all")

    def kernel(_name, run, inputs):
        return mode.opaque(run, inputs)

    prev_hook = kernels.set_cost_hook(kernel)
    for m in sites:
        m.shard_dim_alltoall = alltoall
    try:
        with _propagation_uncounted(mode), mode:
            yield mode
    finally:
        for m in sites:
            m.shard_dim_alltoall = orig
        kernels.set_cost_hook(prev_hook)


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def _param_class(family: str):
    if family == "lm":
        from repro_torch.models.transformer import LMParams
        return LMParams
    if family == "gnn":
        from repro_torch.models.gnn import GNNParams
        return GNNParams
    from repro_torch.models.dien import DIENParams
    return DIENParams


def _as_dtensor(pair):
    """A ``Sharded`` pair as a ``meta`` DTensor holding rank 0's block (a
    replicated 0-d pair, AdamW's step, as a plain ``meta`` tensor, as
    ``sharding.place`` leaves a real one)."""
    t, sharding = pair.tensor, pair.sharding
    if t.dim() == 0 and not any(sharding.spec):
        return torch.empty((), dtype=t.dtype, device="meta")
    block = torch.empty(sharding.local_shape(tuple(t.shape)), dtype=t.dtype,
                        device="meta")
    out = DTensor.from_local(block, sharding.mesh, sharding.placements,
                             run_check=False, shape=t.shape,
                             stride=torch.empty(t.shape,
                                                device="meta").stride())
    return out.requires_grad_(t.requires_grad)


def _as_dtensors(tree):
    from repro_torch.distributed.sharding import Sharded
    if isinstance(tree, Sharded):
        return _as_dtensor(tree)
    if isinstance(tree, dict):
        return {k: _as_dtensors(v) for k, v in tree.items()}
    return tree


def _memory(mode: CostMode, args: int, out) -> dict:
    seen, output, alias = set(), 0, 0
    for t in local_tensors(out):
        key = CostMode._key(t)
        if key in seen:
            continue
        seen.add(key)
        n = t.untyped_storage().nbytes()
        output += n
        if key in mode._args:
            alias += n
    return {"argument_size_in_bytes": args, "output_size_in_bytes": output,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": mode.peak}


def analyze_cell(spec, shape_name: str, mesh, *, smoke: bool = False
                 ) -> dict:
    """One step of the cell on ``mesh`` counted per card: ``{"cost":
    OpCost, "memory_analysis": {...}}``. The cell is built on ``meta``
    (``build_cell(..., device="meta")``), each ``Sharded`` pair of its
    state and inputs becomes a ``meta`` DTensor holding rank 0's block (the
    counterpart of the reference's ``jax.jit(step_fn).lower(state_abs,
    inputs_abs)``), and ``step_fn`` runs once under ``counting()``. Run it
    inside ``launch.dryrun.fake_world`` with ``mesh`` built there."""
    from repro_torch.train.step import build_cell
    step_fn, state, inputs = build_cell(spec, shape_name, mesh,
                                        device="meta", smoke=smoke)
    cls = _param_class(spec.family)
    train = spec.shapes[shape_name]["kind"] == "train"
    state = _as_dtensors(state)
    if train:
        params = cls.from_named(state["params"])
        for name, p in params.named_parameters():
            p.requires_grad_(state["params"][name].requires_grad)
        state = {"params": params, "opt": state["opt"]}
    else:
        state = cls.from_named(state)
    batch = _as_dtensors(inputs)
    with counting() as mode:
        args = mode.arguments((state, batch))
        out = step_fn(state, batch)
    return {"cost": mode.cost, "memory_analysis": _memory(mode, args, out)}
