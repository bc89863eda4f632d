"""Depolarizing channel and syndrome extraction (port of
`qldpcsim_tpu/channel/depolarizing.py`).

Under DEPOLARIZE1(p) each qubit suffers X, Y, Z with probability p/3 each.
One 32-bit threefry draw per qubit partitions [0, 2^32) at the thresholds
p/3, 2p/3 and p; err_x is set for {X, Y} and err_z for {Y, Z}. The syndromes
are sy_z = Hz err_x and sy_x = Hx err_z (mod 2).

The draw of a shot tile is `jax.random.bits(key_tile, (tile, n))` of the
reference, reproduced bit for bit. On a CUDA device `sample_shot_tiles` is
one launch of kernel A (`ops/channel_cuda.py`), which forms the syndromes
from the errors it draws as XOR parities over CSR tables of Hx and Hz;
`syndromes_of` is the reference's float32 product, for errors that come
from elsewhere (the encoder's framed words).
"""

from __future__ import annotations

import torch

from qldpcsim_torch.ops.channel_cuda import (
    SyndromeTables,
    sample_shot_tiles_cuda,
    sample_shot_tiles_plain,
    thresholds,
)
from qldpcsim_torch.utils.threefry import random_bits


def sample_depolarizing(key: torch.Tensor, p, shape):
    """(err_x, err_z) bool tensors of `shape` under DEPOLARIZE1(p), drawn
    from one (2,) key (the reference's `sample_depolarizing`)."""
    t1, t2, t3 = thresholds(p)
    bits = random_bits(key, shape)
    return bits < t2, (bits >= t1) & (bits < t3)


def syndromes_of(err_x, err_z, Hx_T, Hz_T):
    """(sy_z, sy_x) float32 0/1 syndromes of an error pair.

    Hx_T, Hz_T: (n, m_*) float32 transposed parity-check matrices on the
    errors' device. A float32 product of 0/1 entries counts exactly (counts
    stay far below 2^24), so mod 2 of it is the GF(2) product.
    """
    sy_z = torch.remainder(err_x.to(torch.float32) @ Hz_T, 2.0)
    sy_x = torch.remainder(err_z.to(torch.float32) @ Hx_T, 2.0)
    return sy_z, sy_x


def sample_shot_tiles(keys, p, n: int, tile: int, tabs: SyndromeTables):
    """Sample a batch composed of fixed-size tiles, one key per GLOBAL tile.

    keys: (n_tiles, 2) int64 key words; tabs: the code's `SyndromeTables`
    on the keys' device. Returns err_x, err_z (uint8 0/1) of shape
    (n_tiles * tile, n) and the float32 syndromes sy_z (n_tiles * tile, m_z),
    sy_x (n_tiles * tile, m_x): kernel A in one launch for CUDA tensors, its
    plain version for CPU tensors.
    """
    if keys.is_cuda:
        return sample_shot_tiles_cuda(keys, p, n, tile, tabs)
    if keys.device.type == "cpu":
        return sample_shot_tiles_plain(keys, p, n, tile, tabs)
    raise ValueError(f"unsupported device {keys.device}")
