"""The biconnectivity entry: ``repro_torch.core.bcc.biconnectivity``, one
call from one root, with the traffic's ``args`` (its ``rst_flavor``).

The check holds every field of each sampled ``BCCResult`` to the
reference (``reference.bcc.check_bcc``).
"""
from __future__ import annotations

from repro_torch.core import bcc as port

from rstbench.reference import bcc as ref_bcc

FIELDS = ("pre", "size", "low", "high", "articulation", "bridge", "edge_bcc")


class Entry:
    def __init__(self, graph, traffic: dict):
        self.graph = graph
        self.args = dict(traffic.get("args", {}))

    def call(self, root: int):
        return port.biconnectivity(self.graph, root,
                                   device=self.graph.device, **self.args)

    @staticmethod
    def counters(out) -> dict:
        return {"aux_rounds": out.aux_rounds, "seg_syncs": out.seg_syncs}

    @staticmethod
    def outputs(out) -> dict:
        got = {k: getattr(out, k) for k in FIELDS}
        got["n_bcc"] = out.n_bcc
        return got


def check(src, dst, n: int, samples: list, traffic: dict) -> dict:
    """Summed counts over the sampled ``(root, outputs)``: 0 when right."""
    total: dict[str, int] = {}
    for root, got in samples:
        for k, v in ref_bcc.check_bcc(src, dst, n, root, got).items():
            total[k] = total.get(k, 0) + v
    return total
