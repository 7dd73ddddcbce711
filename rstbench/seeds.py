"""Random streams drawn from a run's ``--seed``.

Every stream is keyed by the seed and a fixed stream name, so the same
seed gives the same inputs, and seeds beyond 32 bits are taken whole.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

ROOTS, WARMUP, SAMPLE, GRAPH = "roots", "warmup", "sample", "graph"


def sequence(seed: int, stream: str) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed), zlib.crc32(stream.encode())])


def numpy_rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(sequence(seed, stream))


def torch_generator(device, seed: int, stream: str):
    """A ``torch.Generator`` on ``device`` seeded from (seed, stream)."""
    state = sequence(seed, stream).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed((int(state[0]) << 31) ^ int(state[1]))
    return g
