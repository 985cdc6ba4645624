"""``jax.random``'s default generator in numpy: Threefry-2x32 keys, the
partitionable ``split`` and ``uniform`` (jax's ``jax_threefry_partitionable``
scheme, its default since jax 0.5).

The reference draws its LM multi-starts with ``jax.random``
(``repro.core.calibrate._multi_starts``); drawing the same bits here
starts the port's fit from the same points, so the two fits can be held
to each other with ``seeds > 1``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

Key = Tuple[np.uint32, np.uint32]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, d: int) -> np.ndarray:
    return (v << np.uint32(d)) | (v >> np.uint32(32 - d))


def threefry2x32(key: Key, x1: np.ndarray, x2: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs
    ``(x1, x2)`` under ``key``; uint32 arithmetic wraps."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = x[0] ^ _rotl(x[1], r)
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: the seed's high and low 32 bits."""
    return np.uint32((seed >> 32) & 0xFFFFFFFF), np.uint32(seed & 0xFFFFFFFF)


def _counters(n: int) -> Tuple[np.ndarray, np.ndarray]:
    """A flat uint64 iota as (high, low) uint32 halves."""
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)``: key ``i`` is the hash of counter
    ``i``."""
    b1, b2 = threefry2x32(key, *_counters(num))
    return [(b1[i], b2[i]) for i in range(num)]


def uniform(key: Key, shape: Tuple[int, ...], *, minval: float = 0.0,
            maxval: float = 1.0, dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform``: random mantissa bits under an exponent of
    1, shifted and scaled to ``[minval, maxval)`` in ``dtype`` (float32,
    or float64 as under ``jax_enable_x64``)."""
    dtype = np.dtype(dtype)
    n = int(np.prod(shape, dtype=np.int64))
    b1, b2 = threefry2x32(key, *_counters(n))
    if dtype == np.float32:
        bits = b1 ^ b2
        mant = (bits >> np.uint32(32 - 23)) | np.float32(1.0).view(np.uint32)
    elif dtype == np.float64:
        bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
        mant = (bits >> np.uint64(64 - 52)) | np.float64(1.0).view(np.uint64)
    else:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    floats = mant.view(dtype) - dtype.type(1.0)
    lo, hi = dtype.type(minval), dtype.type(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).reshape(shape)
