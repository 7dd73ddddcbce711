"""The RST entry: ``repro_torch.core.rst.rooted_spanning_tree``, one tree a
call from one root, with the traffic's ``args`` (its ``method``).

The check holds each sampled tree to the guarantees the traffic names:
``spanning_tree`` (parent), ``component_rep`` (rep, gconn_euler) and
``bfs_tree`` (parent and dist against the reference's BFS).
"""
from __future__ import annotations

from repro_torch.core import rst as port

from rstbench.reference import bfs as ref_bfs
from rstbench.reference import tree as ref_tree


class Entry:
    def __init__(self, graph, traffic: dict):
        self.graph = graph
        self.args = dict(traffic.get("args", {}))

    def call(self, root: int):
        return port.rooted_spanning_tree(self.graph, root,
                                         device=self.graph.device,
                                         **self.args)

    @staticmethod
    def counters(out) -> dict:
        return {"steps": out.steps, "rank_syncs": out.rank_syncs}

    @staticmethod
    def outputs(out) -> dict:
        return {k: getattr(out, k) for k in ("parent", "rep", "dist")
                if getattr(out, k) is not None}


def check(src, dst, n: int, samples: list, traffic: dict) -> dict:
    """Summed counts over the sampled ``(root, outputs)``: 0 when right."""
    want = traffic["guarantees"]
    keys = ref_tree.edge_keys(src, dst, n)
    total: dict[str, int] = {}

    def add(counts: dict):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    for root, got in samples:
        counts, ends = ref_tree.check_spanning_tree(keys, n, root,
                                                    got["parent"])
        if "spanning_tree" in want:
            add(counts)
        if "component_rep" in want:
            add(ref_tree.check_component_rep(ends, got["rep"])
                if "rep" in got else {"bad_rep": n})
        if "bfs_tree" in want:
            dist, parent = ref_bfs.bfs(src, dst, n, root)
            add(ref_bfs.check_bfs_tree(dist, parent, got["parent"],
                                       got.get("dist")))
    return total
