"""The JAX package's RANSAC draws, made in PyTorch (no JAX needed), on any
device: so the port on a CUDA card can run with the very draws the JAX
package makes on the CPU for a seed, and a difference between the two runs
is not the draws'.

``jax.random`` with its defaults (``threefry2x32``, partitionable since
JAX 0.5): ``key(seed)`` is ``(0, seed)``; ``split(key, n)`` hashes the
counts ``(0, i)`` under the key; ``uniform(key, shape, float32)`` hashes
the row-major counts ``(0, i)``, xors the two output words, keeps 23
mantissa bits and maps them to [0, 1); ``fold_in(key, d)`` hashes the
count ``(0, d)`` under the key.  ``ScanSfM`` splits its key in three every
frame (``key, k1, k2``) and draws the frame's and the keyframe edge's
(H,N) priorities from ``k1`` and ``k2`` (``scan_draws``); the multi-scene
runner ``run_scenes_scan`` gives scene s the key ``fold_in(key(seed), s)``
(scene 0: ``key(seed)``) and splits each scene's key so
(``scenes_draws``).

    from tools.jax_draws import scan_draws
    scan._pri_source = scan_draws(cfg.ransac.seed, H, N, device="cuda")

``tests/test_torch_jax_draws.py`` holds it bit for bit to ``jax.random``.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1: int, k2: int, x1, x2):
    """Threefry-2x32 (20 rounds) of the counts ``(x1, x2)`` (int64
    tensors holding uint32 values) under the key ``(k1, k2)``."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0, x1 = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32)."""
    return (0, int(seed) & _M32)


def split(k: tuple[int, int], n: int) -> list[tuple[int, int]]:
    """``jax.random.split(k, n)``."""
    c = torch.arange(n, dtype=torch.int64)
    a, b = threefry2x32(k[0], k[1], torch.zeros_like(c), c)
    return [(int(p), int(q)) for p, q in zip(a, b)]


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(k, data)`` for ``data`` in [0, 2**32)."""
    a, b = threefry2x32(k[0], k[1], torch.zeros(1, dtype=torch.int64),
                        torch.tensor([int(data) & _M32]))
    return (int(a), int(b))


def uniform(k: tuple[int, int], shape, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(k, shape, jnp.float32)``: [0, 1)."""
    n = int(np.prod(shape))
    if n >= 2 ** 32:
        raise ValueError("more than 2**32 draws")
    c = torch.arange(n, dtype=torch.int64, device=device)
    a, b = threefry2x32(k[0], k[1], torch.zeros_like(c), c)
    bits = ((a ^ b) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(f, min=0.0).reshape(shape)


def scan_draws(seed: int, H: int, N: int, device="cpu"):
    """The JAX ``ScanSfM``'s draws for ``cfg.ransac.seed = seed``, frames
    in order from 1: a callable frame -> (pri_frame, pri_edge), (H,N)
    float32 numpy arrays (the port's ``ScanSfM._pri_source``)."""
    return _stream(key(seed), H, N, device)


def scenes_draws(seed: int, S: int, H: int, N: int, device="cpu"):
    """The JAX ``run_scenes_scan``'s draws for ``seed`` over S scenes: a
    callable (scene, frame) -> (pri_frame, pri_edge), frames of each scene
    in order from 1 (the port's ``run_scenes_scan(_pri_source=)``)."""
    base = key(seed)
    streams = [_stream(base if s == 0 else fold_in(base, s), H, N, device)
               for s in range(S)]
    return lambda s, idx: streams[s](idx)


def _stream(k: tuple[int, int], H: int, N: int, device):
    state = [k]
    seen = []

    def draws(idx: int):
        if seen and idx != seen[-1] + 1:
            raise ValueError(f"frames out of order: {seen[-1]} then {idx}")
        seen.append(idx)
        state[0], k1, k2 = split(state[0], 3)
        return tuple(uniform(k, (H, N), device).cpu().numpy()
                     for k in (k1, k2))
    return draws
