"""JAX's default random draws (threefry2x32, the partitionable bit layout
JAX uses from 0.5 on) in numpy, bit for bit, so that the port can feed a
model the draws ``mptpu`` trained it with: a SIAM checkpoint fit with
``--fixed-noise`` memorized event ``i``'s noise
``uniform(fold_in(PRNGKey(42), i), (1, 1, min(8192, n)), -1, 1)`` and
decodes as trained only with it (:func:`siam_event_noise`).

Only what those draws need: ``PRNGKey`` of a non-negative 32-bit seed,
``fold_in`` of a 32-bit integer, and float32 ``uniform``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key: Tuple[int, int], x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The 20-round threefry2x32 block cipher of counters (x0, x1) under
    ``key``, as JAX computes it."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, _U32(k0 ^ k1 ^ _U32(0x1BD11BDA)))
    x0 = np.array(x0, dtype=_U32)
    x1 = np.array(x1, dtype=_U32)
    with np.errstate(over="ignore"):
        x0 += ks[0]
        x1 += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 += x1
                x1 = _rotl(x1, r)
                x1 ^= x0
            x0 += ks[(i + 1) % 3]
            x1 += ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2^32."""
    return (0, int(seed))


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for 0 <= data < 2^32."""
    y0, y1 = threefry2x32(key, [0], [data])
    return (int(y0[0]), int(y1[0]))


def uniform(key: Tuple[int, int], shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)`` in
    float32."""
    n = int(np.prod(shape))
    count = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (count >> np.uint64(32)).astype(_U32),
                          (count & np.uint64(0xFFFFFFFF)).astype(_U32))
    mantissa = ((b0 ^ b1) >> _U32(9)) | _U32(0x3F800000)   # a float in [1, 2)
    floats = mantissa.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo).reshape(shape)


def siam_event_noise(n_events: int, size: int, seed: int = 42) -> np.ndarray:
    """(n_events, 1, 1, size): event ``i``'s decoder noise as ``mptpu``
    draws it for a batch of one, ``uniform(fold_in(PRNGKey(seed), i), (1,
    1, size), -1, 1)``."""
    key = prng_key(seed)
    return np.stack([uniform(fold_in(key, i), (1, 1, size), -1.0, 1.0) for i in range(n_events)])
