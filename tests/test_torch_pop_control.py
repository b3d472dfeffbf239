"""Port parity: population control against pauxy_tpu.walkers.pop_control.

Both sides see the same uniforms: the JAX functions draw them from a key,
and the test draws the same numbers from the same key and hands them to
the port. Parents must be equal exactly, weights to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pauxy_tpu.walkers import pop_control as jpc
from pauxy_tpu_torch.walkers import pop_control as tpc

torch.set_num_threads(1)


def weights(kind, nw, rng):
    if kind == "random":
        return rng.exponential(size=nw)
    if kind == "ties":                       # all equal, as after a comb
        return np.ones(nw)
    if kind == "spread":                     # many branch candidates
        return np.concatenate([rng.uniform(0.0, 0.05, nw // 2),
                               rng.uniform(3.0, 9.0, nw - nw // 2)])
    if kind == "some_dead":
        w = rng.exponential(size=nw)
        w[::3] = 0.0
        return w
    return np.zeros(nw)                      # "dead"


KINDS = ["random", "ties", "spread", "some_dead", "dead"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nw,seed", [(24, 0), (101, 1), (1024, 2)])
def test_comb_parents_matches_jax(kind, nw, seed):
    rng = np.random.default_rng(seed)
    w = weights(kind, nw, rng)
    key = jax.random.key(seed)
    parents_j, total_j = jpc.comb_parents(jnp.asarray(w), key, float(nw))
    u = np.asarray(jax.random.uniform(key, (), dtype=jnp.float64))
    parents_t, total_t = tpc.comb_parents(torch.from_numpy(w), float(nw),
                                          uniform=torch.tensor(float(u)))
    np.testing.assert_array_equal(parents_t.numpy(), np.asarray(parents_j))
    assert float(total_t) == pytest.approx(float(total_j), rel=1e-12)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nw,seed", [(24, 3), (101, 4), (1024, 5)])
def test_pair_branch_parents_matches_jax(kind, nw, seed):
    rng = np.random.default_rng(seed)
    w = weights(kind, nw, rng)
    key = jax.random.key(seed)
    parents_j, new_j, total_j = jpc.pair_branch_parents(jnp.asarray(w), key,
                                                        float(nw))
    u = np.asarray(jax.random.uniform(key, (nw // 2,), dtype=jnp.float64))
    parents_t, new_t, total_t = tpc.pair_branch_parents(
        torch.from_numpy(w), float(nw), uniforms=torch.tensor(u))
    np.testing.assert_array_equal(parents_t.numpy(), np.asarray(parents_j))
    np.testing.assert_allclose(new_t.numpy(), np.asarray(new_j), rtol=1e-12,
                               atol=1e-12)
    assert float(total_t) == pytest.approx(float(total_j), rel=1e-12)


def test_generator_draws_are_reproducible():
    w = torch.from_numpy(np.random.default_rng(0).exponential(size=64))
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(11)
        outs.append((tpc.comb_parents(w, 64.0, generator=g)[0],
                     tpc.pair_branch_parents(w, 64.0, generator=g)[0]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
