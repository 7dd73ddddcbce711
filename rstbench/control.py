"""The control of a cell's check: the reference's own answer put in the
program's place, then again with one stated guarantee broken at a time.

    python3 rstbench/control.py --workload <cell> --seeds <n> <n> <n>

For each seed it builds the cell's graph, takes the seed's first root,
works out the reference's answer (a BFS tree, and for biconnectivity its
numbering and blocks), and prints one JSON line per answer with the
numbers the cell's check compares. The reference's answer reads 0
everywhere; every broken answer has to read above a limit, or the check
could not fail. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _pick(mask, rng) -> int:
    idx = torch.nonzero(mask).flatten()
    if idx.numel() == 0:
        raise ValueError("no vertex fits the break")
    return int(idx[int(rng.integers(idx.numel()))])


def reference_answer(src, dst, n: int, root: int, entry: str):
    from rstbench.reference import bcc as ref_bcc
    from rstbench.reference import bfs as ref_bfs
    dist, parent = ref_bfs.bfs(src, dst, n, root)
    if entry == "rst":
        return {"parent": parent.to(torch.int32),
                "rep": torch.full_like(parent, root, dtype=torch.int32),
                "dist": torch.where(dist < 0, ref_bfs.INF32, dist)
                .to(torch.int32)}
    pre, size = ref_bcc.numbering(parent, root)
    got = ref_bcc.reference_bcc(src, dst, n, parent, pre, size)
    return {"pre": pre.to(torch.int32), "size": size.to(torch.int32),
            "low": got["low"].to(torch.int32),
            "high": got["high"].to(torch.int32),
            "articulation": got["articulation"], "bridge": got["bridge"],
            "edge_bcc": got["edge_bcc"].to(torch.int32),
            "n_bcc": got["n_bcc"]}


def breaks(src, dst, n: int, root: int, answer: dict, traffic: dict,
           rng):
    """``(name, answer)`` pairs, each with one guarantee broken."""
    from rstbench.reference import tree as ref_tree
    dev = src.device
    verts = torch.arange(n, device=dev)
    s, d = src.long(), dst.long()
    copy = lambda: {k: (v.clone() if torch.is_tensor(v) else v)
                    for k, v in answer.items()}
    if traffic["entry"] == "rst":
        par = answer["parent"].long()
        x = _pick((verts != root) & (par != root), rng)
        a = copy()
        a["parent"][par[x]] = x                      # a two-vertex cycle
        yield "cycle", a
        y = _pick((verts != root) & (par == root), rng)
        a = copy()
        a["parent"][root] = y                        # rooted elsewhere
        a["parent"][y] = y
        yield "wrong_root", a
        keys = ref_tree.edge_keys(src, dst, n)
        far = ~ref_tree.is_edge(keys, verts, torch.full_like(verts, root), n)
        x = _pick(far & (verts != root), rng)
        a = copy()
        a["parent"][x] = root                        # a tree, not on edges
        yield "non_edge", a
        if "component_rep" in traffic["guarantees"]:
            a = copy()
            x = int(rng.integers(n))
            a["rep"][x] = (a["rep"][x] + 1) % n
            yield "rep", a
        if "bfs_tree" in traffic["guarantees"]:
            dist = answer["dist"].long()
            offer = (dist[d] == dist[s] + 1) & (s != par[d])
            e = _pick(offer, rng)
            a = copy()
            a["parent"][d[e]] = s[e]                 # a BFS tree, not the min
            yield "bfs_parent", a
        return
    x = _pick(verts != root, rng)
    a = copy()
    a["pre"][root], a["pre"][x] = answer["pre"][x], answer["pre"][root]
    yield "numbering", a
    for field in ("low", "high"):
        a = copy()
        a[field][x] += 1
        yield field, a
    for field, size in (("articulation", n), ("bridge", s.numel())):
        a = copy()
        i = int(rng.integers(size))
        a[field][i] = ~a[field][i]
        yield field, a
    a = copy()
    a["edge_bcc"][int(rng.integers(s.numel()))] += 1
    yield "edge_bcc", a
    # A bridge merged into the block above it, as a wrong join in the
    # auxiliary connectivity would merge them.
    from rstbench.reference import bcc as ref_bcc
    par, _ = ref_bcc.tree_from_numbering(src, dst, n, root, answer["pre"],
                                         answer["size"])
    pre = answer["pre"].long()
    deeper = torch.where(pre[d] > pre[s], d, s)
    tree = ref_bcc.is_tree_edge(src, dst, par)
    e = _pick(answer["bridge"] & (par[par[deeper]] != par[deeper]), rng)
    c = deeper[e]
    above = torch.nonzero(tree & (deeper == par[c])).flatten()[0]
    a = copy()
    a["edge_bcc"][tree & (deeper == c)] = answer["edge_bcc"][above]
    yield "merge_blocks", a
    a = copy()
    a["n_bcc"] += 1
    yield "n_bcc", a


def run_control(root: pathlib.Path, workload: str, seed_list, device,
                out=sys.stdout) -> list[dict]:
    from rstbench import catalog, seeds
    bench = catalog.benchmark(root)
    cell = catalog.cell(bench, workload)
    cfg = catalog.config(root, bench, cell["config"])
    tr = catalog.traffic(root, cell["traffic"])
    entry_mod = catalog.entry(root, tr["entry"])
    lines = []
    for seed in seed_list:
        n, src, dst = catalog.generator(root, cfg["generator"]).build(
            cfg["params"], seed, device)
        r = int(seeds.numpy_rng(seed, seeds.ROOTS).integers(0, n, 1)[0])
        rng = seeds.numpy_rng(seed, "control")
        answer = reference_answer(src, dst, n, r, tr["entry"])
        for name, a in [("reference", answer),
                        *breaks(src, dst, n, r, answer, tr, rng)]:
            counts = entry_mod.check(src, dst, n, [(r, a)], tr)
            over = {k: counts.get(k) for k, lim in tr["limits"].items()
                    if counts.get(k) is None or counts[k] > lim}
            line = {"workload": workload, "seed": seed, "root": r,
                    "answer": name, "counts": counts, "over_limit": over,
                    "correct": not over}
            lines.append(line)
            print(json.dumps(line), file=out, flush=True)
        del src, dst, answer
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    lines = run_control(ROOT, args.workload, args.seeds, args.device)
    held = all(ln["correct"] == (ln["answer"] == "reference") for ln in lines)
    print(json.dumps({"workload": args.workload, "control_fails_check":
                      held}), flush=True)
    return 0 if held else 1


if __name__ == "__main__":
    sys.exit(main())
