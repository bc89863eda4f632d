"""Message passing over a circulant-lifted H: CUDA kernel B
(`csrc/ms_qc.cu`), its wrapper, its plain PyTorch version, and the QC
decoder module around them, for two check-node kinds.

Replaces the TPU kernel `qldpcsim_tpu/ops/ms_qc_pallas.py::_make_kernel`
(kind "MS" and kind "BP", built by `make_qc_decoder`). It computes what that
kernel computes, in the same float32 order of operations, per block-row of
each layer group (v = roll(snapshot[j], s) - c2v, slot by slot):

  MS (normalized min-sum):
    m1/m2 = running min / second min of |v| (strict `a < m1`), 1e30 -> 0
    par   = neg_par - 2 floor(neg_par / 2)
    c2v'  = ((beta * ss) * (1 - 2 par)) * (mag - 2 (neg * mag)),
            mag = m2 where |v| == m1 else m1
  BP (tanh-product sum-product):
    t     = sgn(tanh(v * 0.5)) * max(|tanh(v * 0.5)|, 1e-12)    per slot
    prod  = sgn(prod * t) * max(|prod * t|, 1e-30)               running
    th2   = clip(prod / t, -(1 - eps), 1 - eps)
    c2v'  = ss * log((1 + th2) / (1 - th2))
  both:
    post[j] += roll back(c2v' - c2v)                 (frozen lanes: += 0)

with ss = 1 - 2 syndrome, and one syndrome check per iteration, or, with
`qc_check_every="layer"` and more than one layer group, one after every
group: the mismatch bits mis = H e XOR syn start as the syndrome (the prior
is positive, so e = 0), every posterior write flips the bits of the check
rows of the variables whose sign it changed, a shot latches it + 1 when its
bits are all zero after a group, and the freeze mask is re-read per group.
Under F there is one group, and "layer" is "iter". Shots never interact,
so the kernel gives each shot a block of its own, keeps the shot's state
in shared memory, runs the check rows of a layer group side by side (a
thread per edge or per check row; groups that need a snapshot add their
deltas per variable in ascending slot order in a second phase) and leaves
the shot's loop at convergence, which is exactly the Pallas kernel's freeze
of converged lanes. The plain version runs all shots together until
every one has converged or max_iter is reached, masking the updates of
converged shots as the Pallas kernel does; its rolls are index arithmetic
(r + s) mod L.

`ms_qc` runs the kernel for CUDA tensors and the plain version for CPU
tensors. `LAUNCHES[kind]` counts kernel launches. When the decoder is built,
its tables decide how the kernel will run: `QCDecoder.per_edge` (a thread
per edge when the largest layer group's edges fit two passes of 256
threads, as under a layered schedule; else, as under flooding, a thread per
check row), `QCDecoder.threads` per shot (one per edge or row of that group,
in whole warps, up to 256) and `QCDecoder.state_on_device` (True when one
shot's state exceeds a block's shared memory: the same kernel then keeps the
state in device memory). Nothing is decided by a failed launch.

Under F with one check per iteration and a uniform block-row degree,
`make_qc_decoder` can take the slot-stacked kernel F instead
(`ops/flood_qc_cuda.py`): opt-in, as in the reference, by
`QLDPC_QC_STACKED=1` in the environment when the decoder is built, or by
the `stacked` keyword.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from qldpcsim_torch.convert import QCTables, qc_tables_from_reference
from qldpcsim_torch.decoders.common import (
    DecodeResult,
    DecoderConfig,
    LayerSchedule,
)
from qldpcsim_torch.ops import _build, flood_qc_cuda
from qldpcsim_torch.ops.qc import QCStructure, block_groups_of_layers
from qldpcsim_torch.utils.f32math import xla_cpu_logf

KINDS = ("MS", "BP")
LAUNCHES = {kind: 0 for kind in KINDS}

_PRIOR_EPS = np.float32(1e-9)
_BIG = 1e30  # stand-in for +inf in the min reductions, as in the reference
_KERNEL_MAX_DEG = 32  # largest block-row degree ms_qc.cu is instantiated for
MAX_SMEM = 232448     # shared memory one block can use on an H100


def llr_prior(p) -> float:
    """Channel LLR log((1 - p) / max(p, 1e-9)) of a float32 p, on the host.

    The quotient is formed in float32 as in the reference, and the log is
    XLA:CPU's float32 log (`utils/f32math.py`), so the prior equals the
    reference's bit for bit at every float32 p. Kernel and plain version
    share this one value."""
    p = np.float32(p)
    x = (np.float32(1.0) - p) / np.maximum(p, _PRIOR_EPS)
    return float(xla_cpu_logf(x))


def _bp_row(t_raw: torch.Tensor, clamp: float, ss: torch.Tensor
            ) -> torch.Tensor:
    """BP check-node update of one block-row: t_raw = tanh(v / 2) per slot
    (deg, L, B) -> extrinsic messages (deg, L, B)."""
    t = torch.where(t_raw < 0.0, -1.0, 1.0) * torch.clamp_min(t_raw.abs(),
                                                               1e-12)
    prod = torch.ones_like(t[0])
    for d in range(t.shape[0]):
        prod = prod * t[d]
        prod = torch.where(prod < 0.0, -1.0, 1.0) * torch.clamp_min(
            prod.abs(), 1e-30)
    th2 = torch.clamp(prod / t, -clamp, clamp)
    return ss * torch.log((1.0 + th2) / (1.0 - th2))


def _ms_row(v: torch.Tensor, coef: torch.Tensor) -> torch.Tensor:
    """Normalized min-sum check-node update of one block-row: v (deg, L, B),
    coef = beta * ss (L, B) -> extrinsic messages (deg, L, B)."""
    L, B = v.shape[1:]
    a = v.abs()
    neg = (v < 0.0).to(torch.float32)
    m1 = torch.full((L, B), _BIG, dtype=torch.float32, device=v.device)
    m2 = torch.full((L, B), _BIG, dtype=torch.float32, device=v.device)
    for d in range(v.shape[0]):
        is_new = a[d] < m1
        m2 = torch.where(is_new, m1, torch.minimum(m2, a[d]))
        m1 = torch.where(is_new, a[d], m1)
    m1 = torch.where(m1 >= _BIG, 0.0, m1)
    m2 = torch.where(m2 >= _BIG, 0.0, m2)
    neg_par = neg.sum(dim=0)
    par = neg_par - 2.0 * torch.floor(neg_par * 0.5)
    mag = torch.where(a == m1, m2, m1)
    return (coef * (1.0 - 2.0 * par)) * (mag - 2.0 * (neg * mag))


def ms_qc_plain(dec: "QCDecoder", syn_T: torch.Tensor, lch: float):
    """Plain PyTorch version. syn_T: (m, B) float32 0/1 on dec's device.
    Returns posterior (n, B) float32, n_iter (B,) int32, converged (B,)
    bool."""
    tabs = dec.tabs
    L, B = tabs.L, syn_T.shape[1]
    dev = syn_T.device
    f32 = torch.float32
    post = torch.full((tabs.n, B), lch, dtype=f32, device=dev)
    c2v = torch.zeros((tabs.n_slots, L, B), dtype=f32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iter = torch.full((B,), dec.max_iter, dtype=torch.int32, device=dev)
    ss = 1.0 - 2.0 * syn_T                               # (m, B)
    coef_base = dec.beta * ss                            # MS: beta * ss
    gidx = [getattr(dec, f"gidx{i}") for i in range(tabs.m_b)]
    track = dec.track_mis
    if track:
        mis = syn_T.clone()                              # (m, B) 0/1
        hcol = [getattr(dec, f"hcol{i}") for i in range(tabs.m_b)]
    for it in range(dec.max_iter):
        if bool(done.all()):
            break
        active = ~done
        for g in range(len(tabs.group_snap)):
            if track:
                active = ~done
            src = post.clone() if tabs.group_snap[g] else post
            for i in range(int(tabs.group_ptr[g]), int(tabs.group_ptr[g + 1])):
                k0, k1 = int(tabs.row_ptr[i]), int(tabs.row_ptr[i + 1])
                idx = gidx[i]                            # (deg * L,)
                row = c2v[k0:k1]                         # (deg, L, B)
                v = src[idx].view(k1 - k0, L, B) - row
                if dec.kind == "MS":
                    new = _ms_row(v, coef_base[i * L:(i + 1) * L])
                else:
                    new = _bp_row(torch.tanh(v * 0.5), dec.clamp,
                                  ss[i * L:(i + 1) * L])
                new_row = torch.where(active, new, row)
                delta = new_row - row
                c2v[k0:k1] = new_row
                # each variable of the block-row is met by exactly one slot
                # and row, so this gather-add-scatter adds every delta once
                old = post[idx]
                upd = old + delta.reshape(-1, B)
                post[idx] = upd
                if track:
                    flip = ((old < 0.0) != (upd < 0.0)).to(f32)
                    mis = torch.remainder(mis + hcol[i] @ flip, 2.0)
            if track:
                ok = (mis == 0.0).all(dim=0)
                n_iter = torch.where(ok & ~done, it + 1, n_iter)
                done = done | ok
        if track:
            continue
        est = torch.remainder(dec.H @ (post < 0.0).to(f32), 2.0)
        ok = (est == syn_T).all(dim=0)
        n_iter = torch.where(ok & ~done, it + 1, n_iter)
        done = done | ok
    return post, n_iter, done


def ms_qc_cuda(dec: "QCDecoder", syn_T: torch.Tensor, lch: float):
    """Kernel B: the contract of `ms_qc_plain`, on the card. syn_T may have
    any strides (the kernel reads a shot's m syndromes through them; the
    transpose of a (B, m) tensor is read in whole lines). The posterior
    comes back as the (n, B) transpose of a shot-major (B, n) tensor."""
    tabs = dec.tabs
    if syn_T.dtype != torch.float32 or syn_T.dim() != 2 \
            or syn_T.shape[0] != tabs.m:
        raise ValueError(f"syn_T must be ({tabs.m}, B) float32, "
                         f"got {tuple(syn_T.shape)} {syn_T.dtype}")
    if dec.row_ptr.device != syn_T.device:
        raise ValueError(f"decoder tables on {dec.row_ptr.device}, "
                         f"syndromes on {syn_T.device}")
    if tabs.max_deg > _KERNEL_MAX_DEG:
        raise ValueError(f"block-row degree {tabs.max_deg} exceeds the "
                         f"kernel's {_KERNEL_MAX_DEG}")
    B = syn_T.shape[1]
    dev = syn_T.device
    lib = _build.load("ms_qc")
    fn = lib.ms_qc_decode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                    ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 3
                   + [ctypes.c_int] * 11 + [ctypes.c_void_p] * 13)
    post = torch.empty((B, tabs.n), dtype=torch.float32, device=dev)
    state = None
    if dec.state_on_device:
        state = torch.empty((B, dec.state_words), dtype=torch.float32,
                            device=dev)
    n_iter = torch.empty(B, dtype=torch.int32, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(syn_T.data_ptr(), syn_T.stride(0), syn_T.stride(1), B,
            KINDS.index(dec.kind), lch, dec.beta, dec.clamp, dec.max_iter,
            tabs.L, tabs.m_b, tabs.n_b, len(tabs.group_snap), tabs.max_deg,
            tabs.n_slots, dec.delta_slots, int(dec.track_mis),
            int(dec.per_edge), dec.threads,
            dec.row_ptr.data_ptr(), dec.slot_j.data_ptr(),
            dec.slot_s.data_ptr(), dec.slot_row.data_ptr(),
            dec.group_ptr.data_ptr(), dec.group_snap.data_ptr(),
            dec.col_ptr.data_ptr(), dec.col_k.data_ptr(),
            None if state is None else state.data_ptr(), post.data_ptr(),
            n_iter.data_ptr(), conv.data_ptr(), stream)
    _build.check(lib, "ms_qc", rc)
    LAUNCHES[dec.kind] += 1
    return post.T, n_iter, conv


def ms_qc(dec: "QCDecoder", syn_T: torch.Tensor, lch: float):
    """Decode (m, B) float32 syndromes: the kernel for CUDA tensors, the
    plain version for CPU tensors. Returns posterior (n, B), n_iter (B,)
    int32, converged (B,) bool."""
    if syn_T.is_cuda:
        return ms_qc_cuda(dec, syn_T, lch)
    if syn_T.device.type == "cpu":
        return ms_qc_plain(dec, syn_T, lch)
    raise ValueError(f"unsupported device {syn_T.device}")


def layer_groups_for(st: QCStructure, cfg: DecoderConfig,
                     layers: Optional[LayerSchedule]):
    """Block-row groups of the schedule, as the reference's
    `make_qc_decoder` forms them."""
    sched = cfg.schedule.upper()
    if sched == "F":
        return [list(range(st.m_b))]
    if sched == "L":
        if layers is None:
            return [[i] for i in range(st.m_b)]
        groups = block_groups_of_layers(layers, st)
        if groups is None:
            raise ValueError("QC decoder requires block-row-aligned layers")
        return groups
    raise ValueError("QC decoder supports schedules F and L")


class QCDecoder(nn.Module):
    """decode(syndromes, p) -> DecodeResult over a circulant-lifted H
    (the reference's `make_qc_decoder`), kind `cfg.dec_type` (MS or BP).

    Static tables live as int32 buffers on `device`; syndromes must lie on
    the same device. The schedule is 'F' (one snapshot pass over all
    block-rows per iteration) or block-row-aligned 'L'. `stacked` asks for
    the slot-stacked flooding kernel F (None: `QLDPC_QC_STACKED=1` in the
    environment asks); it is taken, as in the reference, only under F with
    one check per iteration, a uniform block-row degree of at most 16 and a
    shot's state within a block's shared memory, else kernel B decodes
    (`self.stacked` says which, on every device).

    For kernel B the tables also fix, here and not at launch, `per_edge`
    (a thread per edge, else per check row), `threads` per shot and
    `state_on_device` (the shot's state in device memory because it exceeds
    a block's shared memory; set it to True to force that variant). For
    kernel F they fix `flood_threads` (threads per shot,
    `flood_qc_cuda.plan`).
    """

    def __init__(self, st: QCStructure, cfg: DecoderConfig,
                 layers: Optional[LayerSchedule] = None,
                 device="cpu", stacked: Optional[bool] = None):
        super().__init__()
        self.kind = cfg.dec_type.upper()
        if self.kind not in KINDS:
            raise ValueError(f"the QC decoder runs kinds {KINDS}, got "
                             f"{cfg.dec_type!r}")
        if cfg.qc_check_every not in ("iter", "layer"):
            raise ValueError("qc_check_every must be 'iter' or 'layer', got "
                             f"{cfg.qc_check_every!r}")
        self.tabs: QCTables = qc_tables_from_reference(
            st, layer_groups_for(st, cfg, layers))
        t = self.tabs
        # the check after every layer group; one group is one check per
        # iteration either way
        self.track_mis = (cfg.qc_check_every == "layer"
                          and len(t.group_snap) > 1)
        if stacked is None:
            stacked = os.environ.get("QLDPC_QC_STACKED") == "1"
        self.stacked = bool(stacked and cfg.schedule.upper() == "F"
                            and cfg.qc_check_every == "iter"
                            and flood_qc_cuda.supports(st, t))
        self.beta = float(np.float32(cfg.beta))
        # BP clamp: 1 - eps in float64, as Python forms it in the reference,
        # then rounded to float32
        self.clamp = float(np.float32(1.0 - float(cfg.eps)))
        self.max_iter = int(cfg.max_iter)
        i32 = torch.int32

        def buf(name, array, dtype=i32):
            self.register_buffer(name, torch.as_tensor(
                np.asarray(array), dtype=dtype, device=device))

        for name in ("row_ptr", "slot_j", "slot_s", "group_ptr",
                     "group_snap"):
            buf(name, getattr(t, name))
        # the lifted H, for the plain versions' per-iteration check
        H = np.zeros((t.m, t.n), np.float32)
        for i in range(t.m_b):
            gi = t.gather_index(i)
            for r in range(t.L):
                H[i * t.L + r, gi[:, r]] = 1.0
        buf("H", H, torch.float32)
        if self.stacked:
            # int32 column view (kernel); int64 indices and bool mask
            # (plain); kernel F's threads per shot
            for name, a in flood_qc_cuda.stacked_tables(t).items():
                buf(f"flood_{name}", a, None)
            self.flood_threads = flood_qc_cuda.plan(t)
            return
        # plain version: gather index per block-row
        for i in range(t.m_b):
            buf(f"gidx{i}", t.gather_index(i).reshape(-1), torch.int64)
        # kernel: the block-row of each slot and the column view of the
        # slots; how many threads a shot gets and where its state lives
        col_ptr, col_k = t.col_slots()
        buf("slot_row", np.repeat(np.arange(t.m_b), np.diff(t.row_ptr)))
        buf("col_ptr", col_ptr)
        buf("col_k", col_k)
        slots = t.row_ptr[t.group_ptr[1:]] - t.row_ptr[t.group_ptr[:-1]]
        self.delta_slots = int((slots * (t.group_snap != 0)).max(initial=0))
        self.table_words = (t.m_b + 1 + 4 * t.n_slots
                            + 2 * len(t.group_snap) + 1 + t.n_b + 1)
        self.state_words = (t.n + (t.n_slots + self.delta_slots) * t.L + t.m
                            + (-(-t.m // 32) if self.track_mis else 0))
        self.state_on_device = (
            4 * (self.table_words + self.state_words) > MAX_SMEM)
        # a thread per edge (8 or 32 lanes side by side per check row) when
        # the largest layer group is done in two passes of 256 threads,
        # else (flooding over a large code) a thread per check row
        rows = int(np.diff(t.group_ptr).max(initial=1)) * t.L
        lanes = 8 if t.max_deg <= 8 else 32
        self.per_edge = rows * lanes <= 512
        work = rows * lanes if self.per_edge else rows
        self.threads = min(256, -(-work // 32) * 32)
        if self.track_mis:
            # per block-row the columns of H at its variables (plain version)
            for i in range(t.m_b):
                buf(f"hcol{i}", H[:, t.gather_index(i).reshape(-1)],
                    torch.float32)

    def forward(self, syndromes: torch.Tensor, p) -> DecodeResult:
        if self.stacked:
            post, n_iter, conv = flood_qc_cuda.flood_qc(
                self, syndromes.to(torch.float32).contiguous(), llr_prior(p))
        else:
            # the transposes are views: the kernel reads (B, m) lines and
            # writes (B, n) lines
            post, n_iter, conv = ms_qc(
                self, syndromes.to(torch.float32).T, llr_prior(p))
            post = post.T
        return DecodeResult(e_hat=(post < 0.0).to(torch.int8), n_iter=n_iter,
                            converged=conv, posterior=post)


def make_qc_decoder(st: QCStructure, cfg: DecoderConfig,
                    layers: Optional[LayerSchedule] = None, device="cpu",
                    stacked: Optional[bool] = None) -> QCDecoder:
    return QCDecoder(st, cfg, layers=layers, device=device, stacked=stacked)


def make_bp_qc_decoder(st: QCStructure, cfg: DecoderConfig,
                       layers: Optional[LayerSchedule] = None, device="cpu",
                       stacked: Optional[bool] = None) -> QCDecoder:
    """The BP kind of `make_qc_decoder`, whatever cfg.dec_type says (the
    reference's `make_bp_qc_decoder`)."""
    return QCDecoder(st, dataclasses.replace(cfg, dec_type="BP"),
                     layers=layers, device=device, stacked=stacked)
