"""level_gap_us.bfs (us/level, program span): the time the card ran
nothing inside the ``bfs.levels`` span (the level loop), over the levels
the traced trees ran: Σ(``steps`` + 1) of their counters, one host read of
the level's flag each."""
from rstbench.metrics import _spans


def read(w):
    s = _spans.span(w, "bfs.levels")
    if s is None:
        return None
    steps = [c.get("steps") for c in w["counters"][:w["profile"]["calls"]]]
    if not steps or None in steps:
        return None
    return 1e6 * s["idle_s"] / sum(k + 1 for k in steps)
