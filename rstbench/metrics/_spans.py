"""Readers shared by the per-layer metrics that read the program's spans:
``w["spans"]``, ``rstbench.spans.reduce_spans`` of the traced calls, which
a run without the program's spans lacks; a reader then finds nothing.
"""


def span(w, name):
    """The reduced span ``name``, or None where it never ran."""
    spans, p = w.get("spans"), w.get("profile")
    if not spans or p is None or not p.get("calls"):
        return None
    s = spans.get(name)
    return s if s and s["count"] else None


def device_ms(w, name):
    """The device time of span ``name``, its child spans included, per
    traced call, in ms."""
    s = span(w, name)
    if s is None or s["device_s"] <= 0:
        return None
    return 1e3 * s["device_s"] / w["profile"]["calls"]


def kernel_roofline(w, name, bytes_per_entry_pass):
    """The bytes the kernel's passes move (``bytes_per_entry_pass`` times
    the span's summed entries × passes) at the card's peak bandwidth, over
    the device time of the kernel's span, in %."""
    s, bw = span(w, name), w.get("peak_bytes_per_s")
    if s is None or bw is None or s["device_s"] <= 0:
        return None
    moved = bytes_per_entry_pass * s["args"].get("entry_passes", 0)
    return 100.0 * (moved / bw) / s["device_s"]
