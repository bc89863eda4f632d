"""Batched GF(2) elimination for OSD: CUDA kernel C (`csrc/gf2_elim.cu`),
its wrapper and its plain PyTorch version.

Replaces two TPU kernels with one contract,
`qldpcsim_tpu/ops/gf2_elim_panel_pallas.py::make_eliminate_panel` (the
reference's default) and `qldpcsim_tpu/ops/gf2_elim_pallas.py::
make_eliminate_pallas` (bit-identical outputs):

    eliminate(colsP) -> (tags, pivots, sel)

colsP (B, n, mW) holds each shot's columns of H in its reliability order,
packed LSB-first over the checks in 32-bit words. The sweep takes the columns
in order and keeps the independent ones in a reduced row-echelon basis
(RREF): a column is reduced by the basis rows whose pivot it covers, its
lowest set bit becomes a new pivot, and the new row is eliminated from the
rows before it. tags[b, k] says which selected columns sum to basis row k
(its bit i is the i-th selected column), pivots[b, k] is row k's pivot
check (-1 where unset), sel[b, j] marks the selected columns. The sweep
stops at rank r.

Words travel as int32 tensors holding the uint32 bits, since torch's
uint32 arithmetic is thin on the CPU; the plain version widens them to
int64 with a 32-bit mask. `eliminate` runs the kernel for CUDA tensors and
the plain version for CPU tensors. `LAUNCHES` counts kernel launches.

The kernel gives each shot a block and keeps the shot's basis at an odd row
stride; `plan(r, mW, rW)` fixes, from the sizes alone, the block's threads,
the row stride, the back-elimination's mapping (a thread per basis row, or
`lanes` threads per row) and whether the basis lies in shared memory or,
beyond a block's 232,448 bytes, in a device-memory scratch. `OSD` asks for
its plan when it is built and keeps the scratch; nothing is decided by a
failed launch, and no size of basis is refused.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from qldpcsim_torch.ops import _build

LAUNCHES = 0

MASK32 = 0xFFFFFFFF
MAX_SMEM = 232448     # shared memory one block can use on an H100
# the C signature of gf2_elim: cols; B, n, mW, r, rW, stride, threads,
# lanes, on_device; scratch, tags, pivots, sel and the stream
ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_int] * 9
            + [ctypes.c_void_p] * 5)


@dataclasses.dataclass(frozen=True)
class ElimPlan:
    """How kernel C runs for one basis size (see `plan`)."""

    threads: int            # per shot (one block)
    stride: int             # words between basis rows (odd)
    lanes: int              # threads per basis row in the back-elimination
    state_on_device: bool   # the basis in a device-memory scratch
    smem_bytes: int         # dynamic shared memory of a block


def plan(r: int, mW: int, rW: int, pairs: Optional[bool] = None
         ) -> ElimPlan:
    """Kernel C's launch for a basis of r rows of mW check words and rW tag
    words. Rows are stored at an odd stride (bw + 1 for an even bw = mW +
    rW), so that threads walking rows side by side read distinct banks.
    Beside the basis, shared memory holds the pivot map (32 mW), the new
    row, two column buffers and two words; the basis goes to device memory
    when it would take the block past 232,448 bytes. `pairs` picks the
    back-elimination's mapping: False gives each basis row a thread, the
    block a thread per row in whole warps, 128 to 512; True gives each row
    bw rounded up to a power of two of threads (at most 32), a word each: a
    thread per (row, word) pair, at most 1024 per block, looping over the
    rows. By default a basis in shared memory takes a thread per row and
    one in device memory a thread per pair, the faster of the two on the
    card for each (chip_smoke.py phase 6)."""
    bw = mW + rW
    stride = bw + 1 if bw % 2 == 0 else bw
    aux = 32 * mW + stride + 2 * mW + 2
    on_device = 4 * (r * stride + aux) > MAX_SMEM
    if pairs is None:
        pairs = on_device
    lanes = min(32, 1 << (bw - 1).bit_length()) if pairs else 1
    top = 1024 if pairs else 512
    threads = min(top, max(128, -(-(r * lanes) // 32) * 32))
    smem = 4 * (aux + (0 if on_device else r * stride))
    return ElimPlan(threads=threads, stride=stride, lanes=lanes,
                    state_on_device=on_device, smem_bytes=smem)


def words_to_int64(w: torch.Tensor) -> torch.Tensor:
    """int32 tensor of uint32 bits -> int64 tensor of the same words."""
    return w.to(torch.int64) & MASK32


def words_to_int32(w: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 words -> int32 tensor of the same bits."""
    return torch.where(w >= 2 ** 31, w - 2 ** 32, w).to(torch.int32)


def xor_fold(x: torch.Tensor, dim: int) -> torch.Tensor:
    """XOR-reduce along `dim` (a halving tree over a zero-padded power of
    two; torch has no XOR reduction)."""
    size = x.shape[dim]
    p2 = 1 << max(0, (size - 1).bit_length())
    if p2 != size:
        shape = list(x.shape)
        shape[dim] = p2 - size
        x = torch.cat([x, x.new_zeros(shape)], dim=dim)
    while p2 > 1:
        p2 //= 2
        x = x.narrow(dim, 0, p2) ^ x.narrow(dim, p2, p2)
    return x.squeeze(dim)


def bit_at(words: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor
           ) -> torch.Tensor:
    """Bit `pos` of packed int64 rows, 0 where not `valid`.

    words: (..., W); pos, valid: (..., K) -> (..., K), the bit of the one
    row at K positions (the leading dims of words and pos agree)."""
    pc = pos.clamp_min(0)
    w = words.gather(-1, pc >> 5)
    return torch.where(valid, (w >> (pc & 31)) & 1, 0)


def eliminate_plain(colsP: torch.Tensor, r: int, rW: int):
    """Plain PyTorch version: the reference's XLA sweep
    (`qldpcsim_tpu/decoders/osd.py::make_osd._eliminate`), batched over
    shots, with its early exit once every shot has r pivots."""
    B, n, mW = colsP.shape
    dev = colsP.device
    i64 = torch.int64
    cols = words_to_int64(colsP)
    basis = torch.zeros((B, r, mW), dtype=i64, device=dev)
    tags = torch.zeros((B, r, rW), dtype=i64, device=dev)
    pivots = torch.full((B, r), -1, dtype=i64, device=dev)
    sel = torch.zeros((B, n), dtype=torch.bool, device=dev)
    cnt = torch.zeros((B,), dtype=i64, device=dev)
    iota_r = torch.arange(r, device=dev)
    iota_t = torch.arange(rW, device=dev)
    for j in range(n):
        if B == 0 or bool((cnt >= r).all()):
            break
        v = cols[:, j]                                       # (B, mW)
        valid = pivots >= 0                                  # (B, r)
        # rows whose pivot the raw column covers (the basis is RREF)
        hm = -bit_at(v, pivots, valid)                       # 0 or all ones
        v = v ^ xor_fold(basis & hm[:, :, None], 1)
        t = xor_fold(tags & hm[:, :, None], 1)               # (B, rW)
        nz = v != 0
        nonzero = nz.any(dim=-1)
        # lowest set bit of the first nonzero word
        w0 = nz.to(torch.int32).argmax(dim=-1).to(i64)
        word = v.gather(1, w0[:, None])[:, 0]
        low = word & -word
        bitpos = torch.frexp(low.to(torch.float64)).exponent.to(i64) - 1
        piv_new = w0 * 32 + bitpos
        # tag of the new row: t ^ e_cnt
        cnt_c = cnt.clamp_max(r - 1)
        self_bit = torch.ones_like(cnt_c) << (cnt_c & 31)
        t_new = t ^ torch.where(
            (iota_t[None, :] == (cnt_c >> 5)[:, None]) & nonzero[:, None],
            self_bit[:, None], 0)
        # back-eliminate the new pivot from the rows before it
        hb = bit_at(basis, piv_new[:, None, None].expand(B, r, 1),
                    valid[:, :, None])[:, :, 0] * nonzero[:, None]
        basis = basis ^ (-hb[:, :, None] & v[:, None, :])
        tags = tags ^ (-hb[:, :, None] & t_new[:, None, :])
        # insert the new row at slot cnt
        upd = nonzero & (cnt < r)
        slot = (iota_r[None, :] == cnt_c[:, None]) & upd[:, None]
        basis = torch.where(slot[:, :, None], v[:, None, :], basis)
        tags = torch.where(slot[:, :, None], t_new[:, None, :], tags)
        pivots = torch.where(slot, piv_new[:, None], pivots)
        sel[:, j] = upd
        cnt = cnt + upd.to(i64)
    return words_to_int32(tags), pivots.to(torch.int32), sel


def eliminate_cuda(colsP: torch.Tensor, r: int, rW: int,
                   plan_: Optional[ElimPlan] = None,
                   scratch: Optional[torch.Tensor] = None):
    """Kernel C: the contract of `eliminate_plain`, on the card (a block per
    shot). `plan_` defaults to `plan(r, mW, rW)`; when it puts the basis in
    device memory, `scratch` (at least B * r * stride int32 words on the
    card) holds it, else one is allocated for the call."""
    global LAUNCHES
    if colsP.dtype != torch.int32 or colsP.dim() != 3 \
            or not colsP.is_contiguous():
        raise ValueError(f"colsP must be contiguous (B, n, mW) int32, got "
                         f"{tuple(colsP.shape)} {colsP.dtype}")
    B, n, mW = colsP.shape
    if not 0 < r <= 32 * mW or rW != -(-r // 32):
        raise ValueError(f"rank {r} and tag words {rW} do not fit {mW} "
                         "check words")
    pl = plan(r, mW, rW) if plan_ is None else plan_
    if pl.stride < mW + rW or pl.stride % 2 == 0:
        raise ValueError(f"plan {pl} does not fit rows of {mW + rW} words")
    dev = colsP.device
    tags = torch.zeros((B, r, rW), dtype=torch.int32, device=dev)
    pivots = torch.full((B, r), -1, dtype=torch.int32, device=dev)
    sel = torch.zeros((B, n), dtype=torch.bool, device=dev)
    if B == 0:
        return tags, pivots, sel
    need = B * r * pl.stride
    if not pl.state_on_device:
        scratch = None
    elif scratch is None:
        scratch = torch.empty(need, dtype=torch.int32, device=dev)
    elif scratch.device != dev or scratch.dtype != torch.int32 \
            or scratch.numel() < need or not scratch.is_contiguous():
        raise ValueError(f"scratch must be {need} contiguous int32 words on "
                         f"{dev}")
    lib = _build.load("gf2_elim")
    fn = lib.gf2_elim
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    _build.require_current(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(colsP.data_ptr(), B, n, mW, r, rW, pl.stride, pl.threads,
            pl.lanes, int(pl.state_on_device),
            None if scratch is None else scratch.data_ptr(), tags.data_ptr(),
            pivots.data_ptr(), sel.data_ptr(), stream)
    _build.check(lib, "gf2_elim", rc)
    LAUNCHES += 1
    return tags, pivots, sel


def eliminate(colsP: torch.Tensor, r: int, rW: int,
              plan_: Optional[ElimPlan] = None,
              scratch: Optional[torch.Tensor] = None):
    """(B, n, mW) int32 packed columns -> tags (B, r, rW) int32, pivots
    (B, r) int32, sel (B, n) bool: the kernel for CUDA tensors (with
    `plan_` and `scratch` as `eliminate_cuda` takes them), the plain version
    for CPU tensors."""
    if colsP.is_cuda:
        return eliminate_cuda(colsP, r, rW, plan_, scratch)
    if colsP.device.type == "cpu":
        return eliminate_plain(colsP, r, rW)
    raise ValueError(f"unsupported device {colsP.device}")
