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

with ss = 1 - 2 syndrome, and one syndrome check per iteration. Lanes never
interact, so the kernel gives each shot its own thread and loop and exits it
at convergence, which is exactly the Pallas kernel's freeze of converged
lanes. The plain version runs all lanes together until every lane has
converged or max_iter is reached, masking the updates of converged lanes as
the Pallas kernel does; its rolls are index arithmetic (r + s) mod L.

`ms_qc` runs the kernel for CUDA tensors and the plain version for CPU
tensors. `LAUNCHES[kind]` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
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
from qldpcsim_torch.ops import _build
from qldpcsim_torch.ops.qc import QCStructure, block_groups_of_layers
from qldpcsim_torch.utils.f32math import xla_cpu_logf

KINDS = ("MS", "BP")
LAUNCHES = {kind: 0 for kind in KINDS}

_PRIOR_EPS = np.float32(1e-9)
_BIG = 1e30  # stand-in for +inf in the min reductions, as in the reference
_KERNEL_MAX_DEG = 32  # largest block-row degree ms_qc.cu is instantiated for


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
    for it in range(dec.max_iter):
        if bool(done.all()):
            break
        active = ~done
        for g in range(len(tabs.group_snap)):
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
                post[idx] = post[idx] + delta.reshape(-1, B)
        est = torch.remainder(dec.H @ (post < 0.0).to(f32), 2.0)
        ok = (est == syn_T).all(dim=0)
        n_iter = torch.where(ok & ~done, it + 1, n_iter)
        done = done | ok
    return post, n_iter, done


def ms_qc_cuda(dec: "QCDecoder", syn_T: torch.Tensor, lch: float):
    """Kernel B: the contract of `ms_qc_plain`, on the card."""
    tabs = dec.tabs
    if syn_T.dtype != torch.float32 or syn_T.dim() != 2 \
            or syn_T.shape[0] != tabs.m or not syn_T.is_contiguous():
        raise ValueError(f"syn_T must be contiguous ({tabs.m}, B) float32, "
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
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 11)
    post = torch.empty((tabs.n, B), dtype=torch.float32, device=dev)
    c2v = torch.empty((tabs.n_slots * tabs.L, B), dtype=torch.float32,
                      device=dev)
    snap = (torch.empty_like(post) if tabs.group_snap.any() else None)
    n_iter = torch.empty(B, dtype=torch.int32, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(syn_T.data_ptr(), B, KINDS.index(dec.kind), lch, dec.beta,
            dec.clamp, dec.max_iter, tabs.L,
            tabs.m_b, tabs.n_b, len(tabs.group_snap), tabs.max_deg,
            tabs.n_slots,
            dec.row_ptr.data_ptr(), dec.slot_j.data_ptr(),
            dec.slot_s.data_ptr(), dec.group_ptr.data_ptr(),
            dec.group_snap.data_ptr(), c2v.data_ptr(), post.data_ptr(),
            None if snap is None else snap.data_ptr(),
            n_iter.data_ptr(), conv.data_ptr(), stream)
    _build.check(lib, "ms_qc", rc)
    LAUNCHES[dec.kind] += 1
    return post, n_iter, conv


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
    block-rows per iteration) or block-row-aligned 'L'.
    """

    def __init__(self, st: QCStructure, cfg: DecoderConfig,
                 layers: Optional[LayerSchedule] = None,
                 device="cpu"):
        super().__init__()
        self.kind = cfg.dec_type.upper()
        if self.kind not in KINDS:
            raise ValueError(f"the QC decoder runs kinds {KINDS}, got "
                             f"{cfg.dec_type!r}")
        if cfg.qc_check_every != "iter":
            raise NotImplementedError(
                "qc_check_every='layer' is not ported yet (ROADMAP queue 1)")
        self.tabs: QCTables = qc_tables_from_reference(
            st, layer_groups_for(st, cfg, layers))
        self.beta = float(np.float32(cfg.beta))
        # BP clamp: 1 - eps in float64, as Python forms it in the reference,
        # then rounded to float32
        self.clamp = float(np.float32(1.0 - float(cfg.eps)))
        self.max_iter = int(cfg.max_iter)
        i32 = torch.int32
        t = self.tabs
        for name in ("row_ptr", "slot_j", "slot_s", "group_ptr",
                     "group_snap"):
            self.register_buffer(name, torch.as_tensor(
                getattr(t, name), dtype=i32, device=device))
        # plain version: gather index per block-row, and the lifted H for
        # its per-iteration check
        for i in range(t.m_b):
            self.register_buffer(f"gidx{i}", torch.as_tensor(
                t.gather_index(i).reshape(-1), dtype=torch.int64,
                device=device))
        H = np.zeros((t.m, t.n), np.float32)
        for i in range(t.m_b):
            gi = t.gather_index(i)
            for r in range(t.L):
                H[i * t.L + r, gi[:, r]] = 1.0
        self.register_buffer("H", torch.as_tensor(H, device=device))

    def forward(self, syndromes: torch.Tensor, p) -> DecodeResult:
        syn_T = syndromes.to(torch.float32).T.contiguous()
        post, n_iter, conv = ms_qc(self, syn_T, llr_prior(p))
        post = post.T
        return DecodeResult(e_hat=(post < 0.0).to(torch.int8), n_iter=n_iter,
                            converged=conv, posterior=post)


def make_qc_decoder(st: QCStructure, cfg: DecoderConfig,
                    layers: Optional[LayerSchedule] = None, device="cpu"
                    ) -> QCDecoder:
    return QCDecoder(st, cfg, layers=layers, device=device)


def make_bp_qc_decoder(st: QCStructure, cfg: DecoderConfig,
                       layers: Optional[LayerSchedule] = None, device="cpu"
                       ) -> QCDecoder:
    """The BP kind of `make_qc_decoder`, whatever cfg.dec_type says (the
    reference's `make_bp_qc_decoder`)."""
    return QCDecoder(st, dataclasses.replace(cfg, dec_type="BP"),
                     layers=layers, device=device)
