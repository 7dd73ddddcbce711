"""setup_s (s, host clock): process start to the first timed call. It
holds the graph's generation, loading (or, in a fresh checkout, building)
the kernels and the warm-up calls."""


def read(w):
    return w["setup_s"]
