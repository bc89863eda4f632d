"""The threefry key contract, frozen: threefry-2x32 (20 rounds) and the key
operations of `jax.random` under `jax_threefry_partitionable=True`, in
numpy uint32 arithmetic.

  * `prng_key(seed)`: the words (seed >> 32, seed & 0xFFFFFFFF);
  * `fold_in(key, data)`: threefry2x32(key, (0, data));
  * `random_bits(key, count)`: for the flat counter i = 0 .. count - 1 the
    hash of the words (i >> 32, i & 0xFFFFFFFF), returned as y0 ^ y1.

A key is a (..., 2) uint32 array.
"""

from __future__ import annotations

import numpy as np

_PARITY = np.uint32(0x1BD11BDA)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The two output words of threefry-2x32 of the counter (x0, x1) under
    the key (k0, k1); broadcastable uint32 arrays, arithmetic mod 2^32."""
    k0, k1 = np.asarray(k0, np.uint32), np.asarray(k1, np.uint32)
    x0, x1 = np.asarray(x0, np.uint32), np.asarray(x1, np.uint32)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"a seed is non-negative, got {seed}")
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    dtype=np.uint32)


def fold_in(key: np.ndarray, data) -> np.ndarray:
    """fold_in of each 32-bit word of `data` (broadcast against the key's
    leading axes)."""
    data = (np.asarray(data, dtype=np.int64) & 0xFFFFFFFF).astype(np.uint32)
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], np.zeros_like(data),
                          data)
    return np.stack([y0, y1], axis=-1)


def random_bits(keys: np.ndarray, count: int) -> np.ndarray:
    """(K, count) uint32 bits of K keys (K, 2)."""
    idx = np.arange(count, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)[None, :]
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)[None, :]
    y0, y1 = threefry2x32(keys[:, 0:1], keys[:, 1:2], hi, lo)
    return y0 ^ y1
