"""The port's tree analytics against ``repro``, bit for bit.

``depths`` and ``subtree_sizes`` on the same numpy parent arrays: a random
forest with relabelled ids, a long path (depth 199, one scatter-add level
each), a star and a single vertex. Tolerance: bit-equal (int32).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core.analytics import depths as jax_depths
from repro.core.analytics import subtree_sizes as jax_subtree_sizes
from repro_torch.core import depths, subtree_sizes


def _random_forest(n, seed):
    rng = np.random.default_rng(seed)
    p = (rng.random(n) * np.arange(n)).astype(np.int64)
    roots = rng.random(n) < 0.05
    p[roots] = np.arange(n)[roots]
    perm = rng.permutation(n)
    q = np.empty(n, np.int64)
    q[perm] = perm[p]
    return q.astype(np.int32)


PARENTS = {
    "forest_400": lambda: _random_forest(400, 4),
    "path_200": lambda: np.maximum(np.arange(200) - 1, 0).astype(np.int32),
    "star_50": lambda: np.zeros(50, np.int32),
    "single": lambda: np.zeros(1, np.int32),
}


@pytest.mark.parametrize("name", sorted(PARENTS))
def test_depths_and_subtree_sizes_match_jax(name):
    parent = PARENTS[name]()
    p = torch.from_numpy(parent)
    np.testing.assert_array_equal(np.asarray(jax_depths(jnp.asarray(parent))),
                                  depths(p).numpy())
    sizes = subtree_sizes(p)
    np.testing.assert_array_equal(
        np.asarray(jax_subtree_sizes(jnp.asarray(parent))), sizes.numpy())
    roots = parent == np.arange(parent.size)
    assert int(sizes[torch.from_numpy(roots)].sum()) == parent.size
