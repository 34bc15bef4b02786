"""tools/jax_draws.py (the JAX package's RANSAC draws made in PyTorch, for
the port on a card) against ``jax.random`` on the CPU: bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import jax_draws

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 32 - 1])
def test_torch_jax_draws_key_and_split(seed):
    k = jax.random.PRNGKey(seed)
    assert tuple(int(v) for v in k) == jax_draws.key(seed)
    for n in (2, 3, 5):
        want = [tuple(int(v) for v in r) for r in jax.random.split(k, n)]
        assert jax_draws.split(jax_draws.key(seed), n) == want


@pytest.mark.parametrize("shape", [(3, 5), (64, 301)])
def test_torch_jax_draws_uniform(shape):
    k = jax.random.split(jax.random.PRNGKey(7), 2)[1]
    want = np.asarray(jax.random.uniform(k, shape, jnp.float32))
    got = jax_draws.uniform(tuple(int(v) for v in k), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_torch_jax_draws_scan_stream():
    """The ScanSfM stream (tests/test_torch_wholerun.py's ``draws``): one
    split in three a frame, the frame's and the edge's priorities from the
    second and third keys; frames must come in order."""
    H, N, seed = 16, 40, 12345
    draws = jax_draws.scan_draws(seed, H, N)
    key = jax.random.PRNGKey(seed)
    for idx in (1, 2, 3):
        key, k1, k2 = jax.random.split(key, 3)
        a, b = draws(idx)
        np.testing.assert_array_equal(
            a, np.asarray(jax.random.uniform(k1, (H, N), jnp.float32)))
        np.testing.assert_array_equal(
            b, np.asarray(jax.random.uniform(k2, (H, N), jnp.float32)))
    with pytest.raises(ValueError):
        draws(5)


def test_torch_jax_draws_scenes_stream():
    """The multi-scene runner's streams: scene s's key is ``fold_in(base,
    s)`` (scene 0: ``base``), split in three a frame as in ScanSfM."""
    H, N, seed, S = 8, 24, 12345, 3
    for d in (0, 1, 2, 2 ** 32 - 1):
        want = jax.random.fold_in(jax.random.PRNGKey(seed), d)
        assert jax_draws.fold_in(jax_draws.key(seed), d) == tuple(
            int(v) for v in want)
    draws = jax_draws.scenes_draws(seed, S, H, N)
    base = jax.random.PRNGKey(seed)
    keys = [base] + [jax.random.fold_in(base, s) for s in range(1, S)]
    for idx in (1, 2):
        for s in range(S):
            keys[s], k1, k2 = jax.random.split(keys[s], 3)
            a, b = draws(s, idx)
            np.testing.assert_array_equal(
                a, np.asarray(jax.random.uniform(k1, (H, N), jnp.float32)))
            np.testing.assert_array_equal(
                b, np.asarray(jax.random.uniform(k2, (H, N), jnp.float32)))
