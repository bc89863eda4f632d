"""The depolarizing channel on the threefry stream, and the syndromes.

Each qubit suffers X, Y or Z with probability p/3 each. One 32-bit draw
per qubit is compared with the thresholds t(p/3), t(2p/3) and t(p), where
t(q) = round(q * 2^32) in float32 (half to even), clipped below 2^32, and
p/3 and 2p/3 = (2 p)/3 are formed in float32: the qubit has an X part
(X or Y) when the draw is below t(2p/3), a Z part (Y or Z) when it lies in
[t(p/3), t(p)).

Shots come in tiles of `tile` shots: tile t of key branch `key_p` draws
random_bits(fold_in(key_p, t), tile * n), row-major (shot, qubit).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from portbench.reference import keys

_F32_BELOW_2_32 = np.float32(4294967040.0)


def _threshold(q: np.float32) -> np.uint64:
    t = np.round(np.float32(q) * np.float32(4294967296.0))
    return np.uint64(np.clip(t, np.float32(0.0), _F32_BELOW_2_32))


def thresholds(p: float) -> Tuple[np.uint64, np.uint64, np.uint64]:
    p = np.float32(p)
    three = np.float32(3.0)
    return (_threshold(p / three), _threshold(np.float32(2.0) * p / three),
            _threshold(p))


def branch_key(seed: int, p_index: int) -> np.ndarray:
    """The key of a run's p-point: fold_in(prng_key(seed), p_index)."""
    return keys.fold_in(keys.prng_key(seed), p_index)


def sample(seed: int, p_index: int, p: float, n: int, tile: int,
           first_tile: int, n_tiles: int) -> Tuple[np.ndarray, np.ndarray]:
    """(err_x, err_z) uint8 (n_tiles * tile, n) of global tiles first_tile
    .. first_tile + n_tiles - 1."""
    key_p = branch_key(seed, p_index)
    tile_keys = keys.fold_in(key_p, np.arange(first_tile,
                                              first_tile + n_tiles))
    bits = keys.random_bits(tile_keys, tile * n).reshape(
        n_tiles * tile, n).astype(np.uint64)
    t1, t2, t3 = thresholds(p)
    err_x = bits < t2
    err_z = (bits >= t1) & (bits < t3)
    return err_x.astype(np.uint8), err_z.astype(np.uint8)


def syndrome(H: np.ndarray, err: np.ndarray) -> np.ndarray:
    """H err mod 2 per shot: (B, m) uint8."""
    counts = err.astype(np.float32) @ H.T.astype(np.float32)
    return (counts.astype(np.int64) & 1).astype(np.uint8)
