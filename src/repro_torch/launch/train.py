"""Training driver: ``python -m repro_torch.launch.train --arch <id> [--smoke]``.

The port of ``repro.launch.train``. Runs real steps on the card (or on
the device the caller of ``main`` names). Wires together: config registry
→ host mesh (``make_host_mesh``: a world-1 NCCL mesh on the card, gloo on
the CPU, or the ranks of a group the caller started) → cell factory on
that mesh → fault-tolerant loop (checkpoint/restart, watchdog, straggler
log) → synthetic data per family (``lm``, ``gnn``, ``recsys``). A cell
whose state and inputs (the dry run's bytes) exceed one card on the mesh
is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_arch
from repro_torch.core.graph import resolve_device
from repro_torch.data.gnn_batch import random_graph_batch
from repro_torch.distributed.sharding import gather_tree
from repro_torch.launch.mesh import host_mesh_session
from repro_torch.train.fault import FaultTolerantLoop
from repro_torch.train.step import ATOM_TYPES, POSITIONS, build_cell

#: One card's memory where the device is not a card: an H100's 80 GB.
CARD_BYTES = 80e9


# The reference's shape of a ``--smoke`` run, by family: the cell named
# "smoke".
SMOKE_SHAPES = {
    "lm": dict(kind="train", batch=4, seq=64),
    "gnn": dict(kind="train", n_nodes=64, n_edges=256, d_feat=16, n_graphs=4),
    "recsys": dict(kind="train", batch=16),
}


def synthetic_batches(spec, shape, cfg, seed=0, *,
                      device: str | torch.device | None = None):
    """Yield (cursor, batch) forever — family-appropriate synthetic data.

    The same numpy draws in the same order as the reference, so one seed
    gives the reference's arrays exactly, as tensors on ``device`` (the
    card unless the caller passes another).

    GNN: batch ``cursor`` is ``random_graph_batch(seed=seed + cursor)``
    (positions for SchNet, DimeNet and MeshGraphNet, atom types for SchNet
    and DimeNet, 4 E triplets for DimeNet) as ``{"graph": its tensors,
    "labels"}``, the labels drawn from the generator seeded ``seed``: GAT's
    classes per node, MeshGraphNet's [N, 3] targets, the others' energies
    per graph.

    DIEN: for a ``retrieval`` shape the batch also holds ``cand_items``
    and ``cand_cates`` [n_candidates], drawn from a second generator
    (seeded ``[seed, 1]``) so that the reference's draws stay as they are
    (the reference has no retrieval data).
    """
    dev = resolve_device(device)
    if spec.family == "lm":
        return _lm_batches(shape, cfg, seed, dev)
    if spec.family == "gnn":
        return _gnn_batches(spec.arch_id, shape, cfg, seed, dev)
    if spec.family == "recsys":
        return _recsys_batches(shape, cfg, seed, dev)
    raise KeyError(f"{spec.arch_id}: unknown family {spec.family!r}")


def _lm_batches(shape, cfg, seed, dev):
    rng = np.random.default_rng(seed)
    cursor = 0
    while True:
        b, s = shape["batch"], shape["seq"]
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s + 1)
                                             ).astype(np.int32)).to(dev)
        yield cursor, {"tokens": toks[:, :-1].contiguous(),
                       "targets": toks[:, 1:].contiguous()}
        cursor += 1


def _gnn_batches(arch_id, shape, cfg, seed, dev):
    rng = np.random.default_rng(seed)
    cursor = 0
    while True:
        nt = 4 * shape["n_edges"] if arch_id == "dimenet" else 0
        g = random_graph_batch(shape["n_nodes"], shape["n_edges"],
                               shape["d_feat"], seed=seed + cursor,
                               positions=arch_id in POSITIONS,
                               atom_types=arch_id in ATOM_TYPES,
                               n_graphs=shape["n_graphs"], max_triplets=nt,
                               device=dev)
        gd = {"node_feat": g.node_feat, "src": g.src, "dst": g.dst,
              "graph_id": g.graph_id}
        if g.positions is not None:
            gd["positions"] = g.positions
        if g.trip_in is not None:
            gd["trip_in"] = g.trip_in
            gd["trip_out"] = g.trip_out
        if arch_id == "gat-cora":
            labels = rng.integers(0, cfg.n_classes, shape["n_nodes"]
                                  ).astype(np.int32)
        elif arch_id == "meshgraphnet":
            labels = rng.standard_normal((shape["n_nodes"], 3)
                                         ).astype(np.float32)
        else:
            labels = rng.standard_normal(shape["n_graphs"]).astype(np.float32)
        yield cursor, {"graph": gd, "labels": torch.from_numpy(labels).to(dev)}
        cursor += 1


def _recsys_batches(shape, cfg, seed, dev):
    rng = np.random.default_rng(seed)
    cand_rng = np.random.default_rng([seed, 1])

    def i32(a):
        return torch.from_numpy(a.astype(np.int32)).to(dev)

    cursor = 0
    while True:
        b, t = shape["batch"], cfg.seq_len
        batch = {
            "hist_items": i32(rng.integers(0, cfg.n_items, (b, t))),
            "hist_cates": i32(rng.integers(0, cfg.n_cates, (b, t))),
            "hist_mask": torch.from_numpy(rng.random((b, t)) < 0.9).to(dev),
            "target_item": i32(rng.integers(0, cfg.n_items, b)),
            "target_cate": i32(rng.integers(0, cfg.n_cates, b)),
            "user_feats": i32(rng.integers(0, cfg.n_user_feats,
                                           (b, cfg.user_hot))),
            "label": i32(rng.integers(0, 2, b)),
        }
        if shape["kind"] == "retrieval":
            n = shape["n_candidates"]
            batch["cand_items"] = i32(cand_rng.integers(0, cfg.n_items, n))
            batch["cand_cates"] = i32(cand_rng.integers(0, cfg.n_cates, n))
        yield cursor, batch
        cursor += 1


def smoke_spec(spec, cfg):
    """``spec`` with one cell, "smoke", of its family's smoke shape (a
    GNN's ``d_feat`` is its smoke config's input width), as the reference's
    ``--smoke`` builds it."""
    shape = dict(SMOKE_SHAPES[spec.family])
    if spec.family == "gnn":
        shape["d_feat"] = getattr(
            cfg, "d_in", getattr(cfg, "d_in_node", shape["d_feat"]))
    return dataclasses.replace(spec, shapes={"smoke": shape})


def check_fits(spec, shape_name: str, mesh, device) -> float:
    """The cell's bytes a card on ``mesh`` (its state and inputs, as the
    dry run counts them); raises ``NotImplementedError`` when they exceed
    one card (the device's memory, or ``CARD_BYTES`` off a card)."""
    from repro_torch.launch.dryrun import cell_bytes
    per_card = cell_bytes(spec, shape_name, mesh)["bytes_per_device"]["total"]
    card = (torch.cuda.get_device_properties(device).total_memory
            if device.type == "cuda" else CARD_BYTES)
    if per_card > card:
        shape = "x".join(map(str, mesh.shape))
        raise NotImplementedError(
            f"{spec.arch_id}/{shape_name}: {per_card / 1e9:.1f} GB a card "
            f"on the {shape} mesh (the dry run's state and inputs) exceed "
            f"one card's {card / 1e9:.1f} GB")
    return per_card


def main(argv: list[str] | None = None, *,
         device: str | torch.device | None = None) -> FaultTolerantLoop:
    """The CLI: build the cell on the host mesh, resume from the newest
    checkpoint under ``<ckpt-dir>/<arch>``, run to ``--steps`` under
    ``FaultTolerantLoop`` and print ``step … loss … ms`` every 5 steps (and
    at step 1) and a ``done:`` line. Runs on ``device``: the card unless
    the caller passes another. The process group it starts for the mesh
    is destroyed on the way out; the returned loop's state is gathered
    whole (plain tensors)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=10)
    args = ap.parse_args(argv)

    spec = get_arch(args.arch)
    dev = resolve_device(device)
    cfg = spec.make_smoke_config() if args.smoke else spec.make_config()
    if args.smoke:
        spec = smoke_spec(spec, cfg)
        shape_name = "smoke"
    else:
        shape_name = args.shape or list(spec.shapes)[0]
    shape = spec.shapes[shape_name]

    with host_mesh_session(dev.type) as mesh:
        if not args.smoke:
            check_fits(spec, shape_name, mesh, dev)
        step_fn, state, _ = build_cell(spec, shape_name, mesh,
                                       smoke=args.smoke, device=dev)
        loop = FaultTolerantLoop(
            step_fn=step_fn, state=state,
            data_iter=synthetic_batches(spec, shape, cfg, device=dev),
            ckpt_dir=f"{args.ckpt_dir}/{args.arch}",
            ckpt_every=args.ckpt_every)
        loop.resume()

        t0 = time.time()

        def on_metrics(step, metrics, dt):
            if step % 5 == 0 or step == 1:
                loss = float(metrics["loss"])
                print(f"step {step:5d}  loss {loss:.4f}  {dt*1e3:.0f} ms")

        loop.run(args.steps, on_metrics=on_metrics)
        loop.state = gather_tree(loop.state)
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s; "
          f"retries={loop.retries} stragglers={len(loop.stragglers)}")
    return loop


if __name__ == "__main__":
    main()
