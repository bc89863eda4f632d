"""Depolarizing channel on the threefry stream, with the syndromes formed in
the same launch: CUDA kernel A (`csrc/channel.cu`), its wrappers and their
plain PyTorch versions.

Replaces the TPU kernel `qldpcsim_tpu/ops/channel_pallas.py::sample_tiles_hw`
(hardware PRNG) and the XLA syndrome products after it
(`channel/depolarizing.py::syndromes_of`). The hardware stream cannot exist
off the TPU, so the kernel computes the reference's threefry stream
(`channel/depolarizing.py::sample_shot_tiles`) bit for bit; see the source
note in `channel.cu` for what bounds it.

Two variants of one kernel:
  * `sample_shot_tiles_cuda(keys, p, n, tile, tabs)`: err_x, err_z and the
    syndromes sy_z = Hz err_x, sy_x = Hx err_z (mod 2), as exact XOR
    parities over the CSR tables of `SyndromeTables`; the engine's chunk
    runs this one;
  * `sample_tiles_cuda(keys, p, n, tile)`: the errors only.
Each has its plain version (`*_plain`), which runs for CPU tensors and is
the oracle on the card; `sample_tiles` dispatches on the keys' device and
raises for anything but CUDA and the CPU. `plan(n, tile, B)` fixes a
launch's shots per block, threads and shared memory. `LAUNCHES` counts the
launches of both variants, `SYN_LAUNCHES` those that formed syndromes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from qldpcsim_torch.ops import _build
from qldpcsim_torch.utils.threefry import random_bits

LAUNCHES = 0
SYN_LAUNCHES = 0

MAX_SMEM = 232448      # shared memory one block can use on an H100
MAX_WARPS = 8          # 256 threads a block
# blocks a launch aims for: about 4 an SM on the H100's 132 SMs at B 4096
TARGET_BLOCKS = 512
# a block's shared memory beyond which the plan takes fewer shots, so that
# 8 blocks of 256 threads still fit an SM
SMEM_PER_BLOCK = MAX_SMEM // 8
# the C signature of channel_depolarizing: keys; n_tiles, tile, n, log2 S,
# threads, smem; t1, t2, t3; err_x, err_z; rp_z, cols_z, m_z; rp_x, cols_x,
# m_x; sy_z, sy_x and the stream
ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_uint] * 3
            + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 2
            + [ctypes.c_int] + [ctypes.c_void_p] * 3)

_U32_MAX_F32 = np.float32(4294967040.0)  # largest float32 below 2^32


def _u32_threshold(q) -> int:
    """round(q * 2^32) in float32 (round half to even), clipped, as an int —
    the reference's `_u32_threshold` on its float32 argument."""
    t = np.round(np.float32(q) * np.float32(4294967296.0))
    return int(np.clip(t, np.float32(0.0), _U32_MAX_F32))


def thresholds(p) -> Tuple[int, int, int]:
    """(t(p/3), t(2p/3), t(p)) with the reference's float32 arithmetic:
    p is rounded to float32 first, and 2p/3 is (2*p)/3."""
    return _thresholds(float(np.float32(p)))


@functools.lru_cache(maxsize=256)
def _thresholds(p: float) -> Tuple[int, int, int]:
    # cached: numpy's float32 scalars cost a chunk's launch tens of
    # microseconds
    p = np.float32(p)
    three = np.float32(3.0)
    return (_u32_threshold(p / three),
            _u32_threshold(np.float32(2.0) * p / three),
            _u32_threshold(p))


@dataclasses.dataclass(frozen=True)
class ChannelPlan:
    """How kernel A runs for one (n, tile, B) (see `plan`)."""

    shots: int        # S, shots of one tile a block draws (a power of two)
    threads: int      # a block's threads, whole warps
    smem_bytes: int   # the block's packed err_x and err_z words

    @property
    def log_shots(self) -> int:
        return self.shots.bit_length() - 1


def _smem(n: int, S: int) -> int:
    """Bytes of a block's two sides of S shots' bits, in 32-bit words."""
    return 8 * (-(-n * S // 32))


@functools.lru_cache(maxsize=256)
def plan(n: int, tile: int, B: int) -> ChannelPlan:
    """Kernel A's launch for B shots of n qubits in tiles of `tile`: S
    shots a block, the largest power of two up to 32 that divides the tile,
    still gives `TARGET_BLOCKS` blocks and keeps the block's bits (n S of
    each side, packed in 32-bit words) within `SMEM_PER_BLOCK`, else 1; a
    warp for each of the block's words of a side, up to 8. Raises ValueError
    when a single shot's words exceed a block's 232,448 bytes."""
    if n < 1 or tile < 1 or B < 0 or B % tile:
        raise ValueError(f"no plan for n {n}, tile {tile}, B {B}")
    if _smem(n, 1) > MAX_SMEM:
        raise ValueError(f"a shot of n = {n} qubits needs {_smem(n, 1)} "
                         f"bytes of shared memory, beyond a block's "
                         f"{MAX_SMEM}")
    S = 32
    while S > 1 and (tile % S or B // S < TARGET_BLOCKS
                     or _smem(n, S) > SMEM_PER_BLOCK):
        S //= 2
    words = _smem(n, S) // 8
    warps = 1 << (min(MAX_WARPS, words).bit_length() - 1)
    return ChannelPlan(shots=S, threads=32 * warps,
                       smem_bytes=_smem(n, S))


@dataclasses.dataclass(frozen=True)
class CheckTable:
    """One check matrix in CSR form, int32 tensors on one device: row i's
    columns are cols[rp[i]:rp[i + 1]], in ascending order."""

    rp: torch.Tensor
    cols: torch.Tensor

    @property
    def m(self) -> int:
        return self.rp.numel() - 1

    @staticmethod
    def build(H: np.ndarray, device="cpu") -> "CheckTable":
        rows, cols = np.nonzero(H)
        rp = np.zeros(H.shape[0] + 1, dtype=np.int32)
        np.cumsum(np.bincount(rows, minlength=H.shape[0]), out=rp[1:])
        return CheckTable(rp=torch.as_tensor(rp, device=device),
                          cols=torch.as_tensor(cols.astype(np.int32),
                                               device=device))


@dataclasses.dataclass(frozen=True)
class SyndromeTables:
    """Both check matrices of a code on one device: `z` from Hz (the
    Z-checks, which see X errors: sy_z) and `x` from Hx (sy_x)."""

    n: int
    z: CheckTable
    x: CheckTable

    @property
    def device(self) -> torch.device:
        return self.z.rp.device

    @functools.cached_property
    def pointers(self) -> tuple:
        """The kernel's table arguments: rp_z, cols_z, m_z, rp_x, cols_x,
        m_x (fixed for the tables' life, so taken once)."""
        return (self.z.rp.data_ptr(), self.z.cols.data_ptr(), self.z.m,
                self.x.rp.data_ptr(), self.x.cols.data_ptr(), self.x.m)

    @staticmethod
    def build(Hx: np.ndarray, Hz: np.ndarray, device="cpu"
              ) -> "SyndromeTables":
        Hx, Hz = np.asarray(Hx) % 2, np.asarray(Hz) % 2
        if Hx.ndim != 2 or Hz.ndim != 2 or Hx.shape[1] != Hz.shape[1]:
            raise ValueError(f"Hx {Hx.shape} and Hz {Hz.shape} must be "
                             "matrices over the same qubits")
        return SyndromeTables(n=Hx.shape[1], z=CheckTable.build(Hz, device),
                              x=CheckTable.build(Hx, device))


def csr_parity(err: torch.Tensor, tab: CheckTable) -> torch.Tensor:
    """(B, m) float32 0/1: the parity of each check's columns of the
    (B, n) 0/1 uint8 `err`, from `tab`'s CSR form. The columns are gathered
    in row order and summed by a running count modulo 256, whose
    difference at the row bounds keeps the parity."""
    B = err.shape[0]
    run = torch.zeros((B, tab.cols.numel() + 1), dtype=torch.uint8,
                      device=err.device)
    torch.cumsum(err[:, tab.cols.long()], dim=1, dtype=torch.uint8,
                 out=run[:, 1:])
    rp = tab.rp.long()
    return ((run[:, rp[1:]] - run[:, rp[:-1]]) & 1).to(torch.float32)


def sample_tiles_plain(keys: torch.Tensor, p, n: int, tile: int):
    """Plain PyTorch version: (err_x, err_z) uint8 0/1 of shape
    (n_tiles * tile, n), one `random_bits(key_t, (tile, n))` draw per tile."""
    t1, t2, t3 = thresholds(p)
    bits = random_bits(keys, (tile, n)).reshape(-1, n)
    err_x = (bits < t2).to(torch.uint8)
    err_z = ((bits >= t1) & (bits < t3)).to(torch.uint8)
    return err_x, err_z


def sample_shot_tiles_plain(keys: torch.Tensor, p, n: int, tile: int,
                            tabs: SyndromeTables):
    """Plain PyTorch version of the fused launch: `sample_tiles_plain`, then
    sy_z (B, m_z) and sy_x (B, m_x) float32 0/1 by `csr_parity`."""
    err_x, err_z = sample_tiles_plain(keys, p, n, tile)
    return (err_x, err_z, csr_parity(err_x, tabs.z),
            csr_parity(err_z, tabs.x))


def _launch(keys: torch.Tensor, p, n: int, tile: int, tabs):
    """Kernel A on the card: the errors, and the syndromes when `tabs` is
    given."""
    global LAUNCHES, SYN_LAUNCHES
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys must be (n_tiles, 2) int64, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if tile * n >= 2**32:
        raise ValueError("tile * n must stay below 2^32")
    dev = keys.device
    if tabs is not None and (tabs.n != n or tabs.device != dev):
        raise ValueError(f"syndrome tables of n {tabs.n} on {tabs.device} "
                         f"for n {n} on {dev}")
    B = keys.shape[0] * tile
    pl = plan(n, tile, B)
    out = (torch.empty((B, n), dtype=torch.uint8, device=dev),
           torch.empty((B, n), dtype=torch.uint8, device=dev))
    if tabs is not None:
        out += (torch.empty((B, tabs.z.m), dtype=torch.float32, device=dev),
                torch.empty((B, tabs.x.m), dtype=torch.float32, device=dev))
    if B == 0:
        return out
    keys = keys.contiguous()
    lib = _build.load("channel")
    fn = lib.channel_depolarizing
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    t1, t2, t3 = thresholds(p)
    # the raw handle: torch.cuda.current_stream() costs a chunk's launch
    # several microseconds of host time
    _build.require_current(dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if tabs is None:
        tables = [None, None, 0, None, None, 0, None, None]
    else:
        tables = [*tabs.pointers, out[2].data_ptr(), out[3].data_ptr()]
    rc = fn(keys.data_ptr(), keys.shape[0], tile, n, pl.log_shots, pl.threads,
            pl.smem_bytes, t1, t2, t3, out[0].data_ptr(), out[1].data_ptr(),
            *tables, stream)
    _build.check(lib, "channel", rc)
    LAUNCHES += 1
    SYN_LAUNCHES += tabs is not None
    return out


def sample_tiles_cuda(keys: torch.Tensor, p, n: int, tile: int):
    """Kernel A, errors only: the same contract as `sample_tiles_plain`, on
    the card."""
    return _launch(keys, p, n, tile, None)


def sample_shot_tiles_cuda(keys: torch.Tensor, p, n: int, tile: int,
                           tabs: SyndromeTables):
    """Kernel A with the syndromes: the same contract as
    `sample_shot_tiles_plain`, on the card, in one launch."""
    return _launch(keys, p, n, tile, tabs)


def sample_tiles(keys: torch.Tensor, p, n: int, tile: int):
    """(err_x, err_z) uint8 0/1 (n_tiles * tile, n) for per-tile keys
    (n_tiles, 2): the kernel for CUDA tensors, the plain version for CPU."""
    if keys.is_cuda:
        return sample_tiles_cuda(keys, p, n, tile)
    if keys.device.type == "cpu":
        return sample_tiles_plain(keys, p, n, tile)
    raise ValueError(f"unsupported device {keys.device}")
