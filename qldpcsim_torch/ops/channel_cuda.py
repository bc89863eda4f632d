"""Depolarizing channel on the threefry stream: CUDA kernel A
(`csrc/channel.cu`), its wrapper and its plain PyTorch version.

Replaces the TPU kernel `qldpcsim_tpu/ops/channel_pallas.py::sample_tiles_hw`
(hardware PRNG). The hardware stream cannot exist off the TPU, so the kernel
computes the reference's threefry stream (`channel/depolarizing.py::
sample_shot_tiles`) bit for bit; see the source note in `channel.cu` for what
bounds it.

`sample_tiles` runs the kernel for CUDA tensors and the plain version for CPU
tensors, and raises for anything else. `LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from qldpcsim_torch.ops import _build
from qldpcsim_torch.utils.threefry import random_bits

LAUNCHES = 0

_U32_MAX_F32 = np.float32(4294967040.0)  # largest float32 below 2^32


def _u32_threshold(q) -> int:
    """round(q * 2^32) in float32 (round half to even), clipped, as an int —
    the reference's `_u32_threshold` on its float32 argument."""
    t = np.round(np.float32(q) * np.float32(4294967296.0))
    return int(np.clip(t, np.float32(0.0), _U32_MAX_F32))


def thresholds(p) -> Tuple[int, int, int]:
    """(t(p/3), t(2p/3), t(p)) with the reference's float32 arithmetic:
    p is rounded to float32 first, and 2p/3 is (2*p)/3."""
    p = np.float32(p)
    three = np.float32(3.0)
    return (_u32_threshold(p / three),
            _u32_threshold(np.float32(2.0) * p / three),
            _u32_threshold(p))


def sample_tiles_plain(keys: torch.Tensor, p, n: int, tile: int):
    """Plain PyTorch version: (err_x, err_z) uint8 0/1 of shape
    (n_tiles * tile, n), one `random_bits(key_t, (tile, n))` draw per tile."""
    t1, t2, t3 = thresholds(p)
    bits = random_bits(keys, (tile, n)).reshape(-1, n)
    err_x = (bits < t2).to(torch.uint8)
    err_z = ((bits >= t1) & (bits < t3)).to(torch.uint8)
    return err_x, err_z


def _as_u32_words(keys: torch.Tensor) -> torch.Tensor:
    """int64 32-bit words -> int32 tensor with the same bit pattern."""
    return torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32)


def sample_tiles_cuda(keys: torch.Tensor, p, n: int, tile: int):
    """Kernel A: the same contract as `sample_tiles_plain`, on the card."""
    global LAUNCHES
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys must be (n_tiles, 2) int64, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if tile * n >= 2**32:
        raise ValueError("tile * n must stay below 2^32")
    lib = _build.load("channel")
    fn = lib.channel_depolarizing
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_uint, ctypes.c_uint, ctypes.c_uint,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    words = _as_u32_words(keys).contiguous()
    n_tiles = keys.shape[0]
    err_x = torch.empty((n_tiles * tile, n), dtype=torch.uint8,
                        device=keys.device)
    err_z = torch.empty_like(err_x)
    t1, t2, t3 = thresholds(p)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = fn(words.data_ptr(), n_tiles, tile * n, t1, t2, t3,
            err_x.data_ptr(), err_z.data_ptr(), stream)
    _build.check(lib, "channel", rc)
    LAUNCHES += 1
    return err_x, err_z


def sample_tiles(keys: torch.Tensor, p, n: int, tile: int):
    """(err_x, err_z) uint8 0/1 (n_tiles * tile, n) for per-tile keys
    (n_tiles, 2): the kernel for CUDA tensors, the plain version for CPU."""
    if keys.is_cuda:
        return sample_tiles_cuda(keys, p, n, tile)
    if keys.device.type == "cpu":
        return sample_tiles_plain(keys, p, n, tile)
    raise ValueError(f"unsupported device {keys.device}")
