"""Checkpointing: atomic, step-indexed save and restore of state trees.

The port of ``repro.train.checkpoint`` (DESIGN.md §8):

  * a state tree (dicts, lists and tuples of tensors, of the port's
    dataclasses: ``DynamicForest``, ``TourNumbering``, ``DynamicBCC``, ...,
    and of parameter modules: ``DIENParams``, ``GNNParams``) is flattened
    to named leaves: one ``.npz`` payload and a JSON manifest (names,
    shapes, dtypes, step, data cursor). Leaves are tensors and host ints:
    the fields the port keeps as Python ints
    (``DynamicForest.version``, ``DynamicBCC``'s counts, ``n_nodes``)
    round-trip as ints, so a resumed run's counts equal an uninterrupted
    run's. A module's leaves are its ``named_parameters()``; it is rebuilt
    by its class's ``from_named``, each parameter keeping the
    ``requires_grad`` of the matching one in ``state_like``;
  * writes go to a temporary directory, then ``os.replace``: a writer that
    crashes never corrupts the newest checkpoint;
  * ``save(..., blocking=False)`` copies the tensors to the host on the
    caller's thread, then serializes on a background thread;
  * ``restore`` puts each tensor on the device of the matching leaf of
    ``state_like`` (the card, for a state on the card) and rejects a tree
    whose leaf names differ;
  * a DTensor leaf (a sharded train state) is written whole (gathered:
    every rank saves) and restored placed as the matching leaf;
  * retention: keep the newest ``keep`` checkpoints.

The manifest is JSON (the standard library), not the reference's msgpack,
which the port does not depend on; names follow the port's flattening,
so checkpoints are not readable across the two packages.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch

#: torch dtypes numpy holds as they are; any other (bfloat16, the float8s)
#: is written as its raw bytes.
_NATIVE = {torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32,
           torch.int64, torch.float16, torch.float32, torch.float64,
           torch.complex64, torch.complex128}


def _flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(name, leaf)`` pairs in a fixed order: dict keys sorted (as
    ``jax.tree_util`` orders them), list and tuple items by index,
    dataclass fields in declaration order, a module's parameters in
    ``named_parameters()`` order. Leaves are tensors and host ints."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += _flatten(x, f"{prefix}[{i}]")
        return out
    if isinstance(tree, torch.nn.Module):
        return [(f"{prefix}.{name}", p) for name, p in tree.named_parameters()]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += _flatten(getattr(tree, f.name), f"{prefix}.{f.name}")
        return out
    if isinstance(tree, torch.Tensor) or type(tree) is int:
        return [(prefix, tree)]
    raise TypeError(f"checkpoint: unsupported leaf {prefix} of type "
                    f"{type(tree).__name__}")


def _unflatten(like, leaves):
    """``like`` with its leaves replaced, in ``_flatten``'s order, by the
    next items of the iterator ``leaves``."""
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    if isinstance(like, torch.nn.Module):
        named = dict(like.named_parameters())
        module = type(like).from_named({name: next(leaves) for name in named})
        for name, p in module.named_parameters():
            p.requires_grad_(named[name].requires_grad)
        return module
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves)
            for f in dataclasses.fields(like)})
    return next(leaves)


def _kind(leaf) -> str:
    return str(leaf.dtype) if isinstance(leaf, torch.Tensor) else "int"


def _to_host(leaf) -> np.ndarray:
    """A leaf as an npz-safe host array (exotic dtypes as raw bytes)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().cpu().contiguous()
    if t.dtype in _NATIVE:
        return t.numpy()
    return t.reshape(-1).view(torch.uint8).numpy()


def _from_host(raw: np.ndarray, kind: str, shape, like):
    """The leaf ``raw`` decodes to, as ``like`` holds it (a tensor on
    ``like``'s device and dtype, or a host int)."""
    if not isinstance(like, torch.Tensor):
        return int(raw.item())
    dtype = getattr(torch, kind.removeprefix("torch."))
    if dtype in _NATIVE:
        t = torch.from_numpy(np.ascontiguousarray(raw))
    else:
        t = torch.from_numpy(np.ascontiguousarray(raw)).view(dtype)
    t = t.reshape(shape).to(device=like.device, dtype=like.dtype)
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(like, DTensor):
        return distribute_tensor(t, like.device_mesh, like.placements,
                                 src_data_rank=None)
    return t


def save(ckpt_dir: str | pathlib.Path, state, step: int, *,
         data_cursor: int = 0, keep: int = 3, blocking: bool = True,
         extra: dict | None = None):
    """Atomically write ``state`` as checkpoint ``step``.

    ``extra`` is an optional JSON-serializable dict stamped into the
    manifest verbatim; readers find it at ``manifest.get("extra", {})``.
    With ``blocking=False`` the tensors are copied to the host here and
    the files are written on a background thread, which is returned
    (``join`` it); otherwise returns None.
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    flat = _flatten(state)
    names = [name for name, _ in flat]
    kinds = [_kind(leaf) for _, leaf in flat]
    shapes = [list(leaf.shape) if isinstance(leaf, torch.Tensor) else []
              for _, leaf in flat]
    host = [_to_host(leaf) for _, leaf in flat]

    def write():
        tmp = ckpt_dir / f".tmp-{step}-{os.getpid()}-{threading.get_ident()}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "arrays.npz",
                 **{f"leaf_{i}": a for i, a in enumerate(host)})
        manifest = {"step": step, "data_cursor": data_cursor,
                    "names": names, "shapes": shapes, "dtypes": kinds,
                    "time": time.time()}
        if extra is not None:
            manifest["extra"] = extra
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = ckpt_dir / f"step_{step:010d}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        _retain(ckpt_dir, keep)

    if blocking:
        write()
        return None
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _retain(ckpt_dir: pathlib.Path, keep: int):
    ckpts = sorted(d for d in ckpt_dir.iterdir()
                   if d.is_dir() and d.name.startswith("step_"))
    for d in ckpts[:-keep]:
        shutil.rmtree(d, ignore_errors=True)


def latest_step(ckpt_dir: str | pathlib.Path) -> int | None:
    """The newest published step under ``ckpt_dir``, or None."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.is_dir() and d.name.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str | pathlib.Path, state_like, *,
            step: int | None = None):
    """Load checkpoint ``step`` (the newest by default) into the structure
    of ``state_like``.

    Each tensor lands on the device and in the dtype of ``state_like``'s
    leaf of the same name; each host int comes back as an int.
    Raises ``ValueError`` if the leaf names differ (a tree mismatch) and
    ``FileNotFoundError`` if there is no checkpoint. Returns
    ``(state, manifest)``.
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = _flatten(state_like)
    names_now = [name for name, _ in flat]
    if names_now != manifest["names"]:
        raise ValueError("checkpoint tree mismatch: "
                         f"{set(names_now) ^ set(manifest['names'])}")
    with np.load(d / "arrays.npz") as arrays:
        leaves = [_from_host(arrays[f"leaf_{i}"], manifest["dtypes"][i],
                             manifest["shapes"][i], like)
                  for i, (_, like) in enumerate(flat)]
    return _unflatten(state_like, iter(leaves)), manifest
