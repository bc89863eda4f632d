"""Serial (row-sequential) message passing over a circulant-lifted H: CUDA
kernel D (`csrc/seq_qc.cu`), its wrapper, its plain PyTorch version, and the
decoder module around them, for two check-node kinds.

Replaces the TPU kernel `qldpcsim_tpu/ops/seq_qc_pallas.py::_make_kernel`
(kinds "MS" and "BP", built by `make_seq_qc_decoder`): the reference
simulator's serial schedule, one check row per layer in natural row order,
with a convergence test after every row. It computes what that kernel
computes, in the same float32 order of operations. Per shot:

  post[v] = L_ch, c2v = 0, se = row_parity * (L_ch < 0), W = sum |se - syn|
  for it, for block-row i, for row r (check row i * L + r):
    slot d = (j, s):  pos = post[j * L + (r + s) % L], old = c2v[slot d, r],
                      v = pos - old
    MS: m1/m2 = running min / second min of |v| (strict `a < m1`), 1e30 -> 0
        par  = neg_par - 2 floor(neg_par / 2)
        new  = a * b,  a = ((beta * ss) * (1 - 2 par)) * sign,  b = mag,
               sign = 1 - 2 (v < 0), mag = m2 where |v| == m1 else m1
    BP: t    = sgn(tanh(v * 0.5)) * max(|tanh(v * 0.5)|, 1e-12)   per slot
        prod = sgn(prod * t) * max(|prod * t|, 1e-30)              running
        th2  = clip(prod / t, -(1 - eps), 1 - eps)
        new  = a * b,  a = ss,  b = log((1 + th2) / (1 - th2))
    delta = fma(a, b, -old) * active;  c2v <- old + delta;
    post <- pos + delta
    a posterior whose sign changed flips the syndrome estimate `se` of every
    check row that meets the variable, and W moves with it
    after the row: a still-active shot with W == 0 latches n_iter = it + 1
    and is frozen from the next row on

with ss = 1 - 2 syn[row]. `new - old` is one fused multiply-add (a single
rounding): the reference writes `(new - old) * active`, and XLA:CPU, which
runs the reference kernel in interpret mode, contracts the product feeding
that subtraction, so this is what makes the plain version equal it bit for
bit (MS). Kernel and plain version both state the fma explicitly (`fmaf`;
`utils/f32math.fma_f32_torch`) and nothing else is contracted
(`-fmad=false`). The test runs only after a row's update, so a shot
with a zero syndrome still runs row 0 of iteration 0 (n_iter == 1).

Shots never interact, so the kernel gives each shot its own thread, which
leaves its loops at the row where it latches; the plain version runs all
shots together, row by row, and freezes a latched shot by the reference's
multiplication with `active` (which turns a stored -0.0 into +0.0 where the
kernel's departed thread keeps -0.0: the two agree by value, not by bit
pattern, on such entries; `post < 0` is false for both).

`seq_qc` runs the kernel for CUDA tensors and the plain version for CPU
tensors. `LAUNCHES[kind]` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch import nn

from qldpcsim_torch.convert import SeqQCTables, seq_qc_tables_from_reference
from qldpcsim_torch.decoders.common import (
    DecodeResult,
    DecoderConfig,
    LayerSchedule,
)
from qldpcsim_torch.ops import _build
from qldpcsim_torch.ops.ms_qc_cuda import KINDS, llr_prior
from qldpcsim_torch.ops.qc import QCStructure
from qldpcsim_torch.utils.f32math import fma_f32_torch

LAUNCHES = {kind: 0 for kind in KINDS}

_BIG = 1e30  # stand-in for +inf in the min reductions, as in the reference
_KERNEL_MAX_DEG = 32  # largest block-row degree seq_qc.cu is instantiated for


def serial_order_is_natural(layers: Optional[LayerSchedule], m: int) -> bool:
    """True when the schedule is one-row layers in natural order 0..m-1
    (what the greedy layerizer emits for the serial schedule)."""
    if layers is None:
        return False
    rows = []
    for l in range(layers.n_layers):
        size = int(layers.sizes[l])
        if size == 0:
            continue
        if size != 1:
            return False
        rows.append(int(layers.rows[l, 0]))
    return rows == list(range(m))


def _two_smallest(a: torch.Tensor, dim: int = 0):
    """m1, m2 of the reference's running min / second min over the slots
    (`dim`) of a block of magnitudes, 1e30 -> 0. The strict `a < m1` update
    keeps the smallest value in m1 and the second smallest, counted with
    multiplicity, in m2: a selection, so no rounding is involved."""
    if a.shape[dim] >= 2:
        low = torch.topk(a, 2, dim=dim, largest=False).values
        m1, m2 = low.select(dim, 0), low.select(dim, 1)
    else:
        m2 = torch.full_like(a.sum(dim=dim), _BIG)
        m1 = a.select(dim, 0) if a.shape[dim] else m2
    m1 = torch.where(m1 >= _BIG, 0.0, m1)
    m2 = torch.where(m2 >= _BIG, 0.0, m2)
    return m1, m2


def seq_qc_plain(dec: "SeqQCDecoder", syn_T: torch.Tensor, lch: float):
    """Plain PyTorch version. syn_T: (m, B) float32 0/1 on dec's device.
    Returns posterior (n, B) float32, n_iter (B,) int32, converged (B,)
    bool."""
    tabs = dec.tabs
    L, B = tabs.L, syn_T.shape[1]
    dev = syn_T.device
    f32 = torch.float32
    post = torch.full((tabs.n, B), lch, dtype=f32, device=dev)
    c2v = torch.zeros((tabs.n_slots * L, B), dtype=f32, device=dev)
    e0 = 1.0 if lch < 0.0 else 0.0
    se = (dec.row_par_rows * e0)[:, None].expand(tabs.m, B).contiguous()
    W = (se - syn_T).abs().sum(dim=0)                    # (B,), exact integer
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iter = torch.full((B,), dec.max_iter, dtype=torch.int32, device=dev)
    for it in range(dec.max_iter):
        if bool(done.all()):
            break
        for i in range(tabs.m_b):
            vtab = getattr(dec, f"vtab{i}")              # (L, deg) variables
            ctab = getattr(dec, f"ctab{i}")              # (L, deg) c2v rows
            chk = getattr(dec, f"chk{i}")                # (L, K) check rows
            hit = getattr(dec, f"hit{i}")                # (K, deg) 0/1
            for r in range(L):
                active = (~done).to(f32)
                ss = 1.0 - 2.0 * syn_T[i * L + r]        # (B,)
                vidx, cidx = vtab[r], ctab[r]
                pos, old = post[vidx], c2v[cidx]         # (deg, B)
                v = pos - old
                if dec.kind == "MS":
                    neg = (v < 0.0).to(f32)
                    a = v.abs()
                    m1, m2 = _two_smallest(a)
                    neg_par = neg.sum(dim=0)
                    par = neg_par - 2.0 * torch.floor(neg_par * 0.5)
                    coef = (dec.beta * ss) * (1.0 - 2.0 * par)
                    mag = torch.where(a == m1, m2, m1)
                    delta = fma_f32_torch(coef * (1.0 - 2.0 * neg), mag, -old)
                else:
                    t = torch.tanh(v * 0.5)
                    t = torch.where(t < 0.0, -1.0, 1.0) * torch.clamp_min(
                        t.abs(), 1e-12)
                    prod = torch.ones_like(t[0])
                    for d in range(t.shape[0]):
                        prod = prod * t[d]
                        prod = torch.where(prod < 0.0, -1.0, 1.0) \
                            * torch.clamp_min(prod.abs(), 1e-30)
                    th2 = torch.clamp(prod / t, -dec.clamp, dec.clamp)
                    delta = fma_f32_torch(
                        ss, torch.log((1.0 + th2) / (1.0 - th2)), -old)
                delta = delta * active
                c2v[cidx] = old + delta
                new_pos = pos + delta
                post[vidx] = new_pos
                # each flipped variable toggles the estimate of every check
                # row that meets it; toggles of one check row add mod 2, and
                # the reference's slot-by-slot dW telescopes to new - old
                flip = ((pos < 0.0) != (new_pos < 0.0)).to(f32)
                tog = torch.remainder(hit @ flip, 2.0)   # (K, B)
                rows = chk[r]
                se_old = se[rows]
                se_new = (se_old - tog).abs()
                se[rows] = se_new
                sy = syn_T[rows]
                W = W + ((se_new - sy).abs() - (se_old - sy).abs()).sum(dim=0)
                ok = W == 0.0
                n_iter = torch.where(ok & ~done, it + 1, n_iter)
                done = done | ok
    return post, n_iter, done


def seq_qc_cuda(dec: "SeqQCDecoder", syn_T: torch.Tensor, lch: float):
    """Kernel D: the contract of `seq_qc_plain`, on the card."""
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
    lib = _build.load("seq_qc")
    fn = lib.seq_qc_decode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 13)
    post = torch.empty((tabs.n, B), dtype=torch.float32, device=dev)
    n_iter = torch.empty(B, dtype=torch.int32, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    c2v, mis = dec.scratch(B, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(syn_T.data_ptr(), B, KINDS.index(dec.kind), lch, dec.beta,
            dec.clamp, dec.max_iter, tabs.L, tabs.m_b, tabs.n_b,
            tabs.max_deg, tabs.n_slots,
            dec.row_ptr.data_ptr(), dec.slot_j.data_ptr(),
            dec.slot_s.data_ptr(), dec.col_ptr.data_ptr(),
            dec.col_i.data_ptr(), dec.col_s.data_ptr(),
            dec.row_par.data_ptr(), c2v.data_ptr(), mis.data_ptr(),
            post.data_ptr(), n_iter.data_ptr(), conv.data_ptr(), stream)
    _build.check(lib, "seq_qc", rc)
    LAUNCHES[dec.kind] += 1
    return post, n_iter, conv


def seq_qc(dec: "SeqQCDecoder", syn_T: torch.Tensor, lch: float):
    """Decode (m, B) float32 syndromes: the kernel for CUDA tensors, the
    plain version for CPU tensors. Returns posterior (n, B), n_iter (B,)
    int32, converged (B,) bool."""
    if syn_T.is_cuda:
        return seq_qc_cuda(dec, syn_T, lch)
    if syn_T.device.type == "cpu":
        return seq_qc_plain(dec, syn_T, lch)
    raise ValueError(f"unsupported device {syn_T.device}")


class SeqQCDecoder(nn.Module):
    """decode(syndromes, p) -> DecodeResult under the serial schedule over a
    circulant-lifted H in natural row order (the reference's
    `make_seq_qc_decoder`), kind MS or BP.

    Static tables live as buffers on `device`; syndromes must lie on the
    same device. The kernel's message and syndrome-mismatch scratch is
    allocated once per decoder and grown to the largest batch seen.
    """

    def __init__(self, st: QCStructure, cfg: DecoderConfig,
                 layers: Optional[LayerSchedule] = None, device="cpu",
                 kind: str = "MS"):
        super().__init__()
        self.kind = kind.upper()
        if self.kind not in KINDS:
            raise ValueError(f"the serial QC decoder runs kinds {KINDS}, got "
                             f"{kind!r}")
        if layers is not None and not serial_order_is_natural(layers, st.m):
            raise ValueError("the serial QC decoder requires one-row layers "
                             "in natural order")
        self.tabs: SeqQCTables = seq_qc_tables_from_reference(st)
        self.beta = float(np.float32(cfg.beta))
        # BP clamp: 1 - eps in float64, as Python forms it in the reference,
        # then rounded to float32
        self.clamp = float(np.float32(1.0 - float(cfg.eps)))
        self.max_iter = int(cfg.max_iter)
        self._scratch = None
        t = self.tabs
        L = t.L
        for name in ("row_ptr", "slot_j", "slot_s", "col_ptr", "col_i",
                     "col_s", "row_par"):
            self.register_buffer(name, torch.as_tensor(
                getattr(t, name), dtype=torch.int32, device=device))
        # plain version: per block-row, the variables and message rows of
        # each check row, the distinct check rows its variables meet, and
        # which slots' flips toggle each of them
        self.register_buffer("row_par_rows", torch.as_tensor(
            np.repeat(t.row_par, L), dtype=torch.float32, device=device))
        r = np.arange(L)
        for i in range(t.m_b):
            k0, k1 = int(t.row_ptr[i]), int(t.row_ptr[i + 1])
            vtab = t.gather_index(i).T                   # (L, deg)
            ctab = (np.arange(k0, k1)[None, :] * L + r[:, None])
            # check rows met by slot d's variable: block-row i2, row
            # (r + s - s2) % L; equal (i2, offset) pairs are one check row
            keys = {}
            for d in range(k1 - k0):
                j, s = int(t.slot_j[k0 + d]), int(t.slot_s[k0 + d])
                for k in range(int(t.col_ptr[j]), int(t.col_ptr[j + 1])):
                    key = (int(t.col_i[k]), (s - int(t.col_s[k])) % L)
                    keys.setdefault(key, []).append(d)
            chk = np.stack([i2 * L + (r + off) % L for i2, off in keys],
                           axis=1) if keys else np.zeros((L, 0), np.int64)
            hit = np.zeros((len(keys), k1 - k0), np.float32)
            for q, slots in enumerate(keys.values()):
                for d in slots:
                    hit[q, d] += 1.0
            for name, arr, dt in ((f"vtab{i}", vtab, torch.int64),
                                  (f"ctab{i}", ctab, torch.int64),
                                  (f"chk{i}", chk, torch.int64),
                                  (f"hit{i}", hit, torch.float32)):
                self.register_buffer(name, torch.as_tensor(
                    np.ascontiguousarray(arr), dtype=dt, device=device))

    def scratch(self, B: int, device):
        """The kernel's state for B shots: c2v (n_slots * L, B) float32 and
        the syndrome-mismatch bytes (m, B) uint8, views of buffers kept on
        the decoder."""
        t = self.tabs
        need = (t.n_slots * t.L * B, t.m * B)
        s = self._scratch
        if s is None or s[0].device != device or s[0].numel() < need[0]:
            s = (torch.empty(need[0], dtype=torch.float32, device=device),
                 torch.empty(need[1], dtype=torch.uint8, device=device))
            self._scratch = s
        return (s[0][:need[0]].view(t.n_slots * t.L, B),
                s[1][:need[1]].view(t.m, B))

    def forward(self, syndromes: torch.Tensor, p) -> DecodeResult:
        syn_T = syndromes.to(torch.float32).T.contiguous()
        post, n_iter, conv = seq_qc(self, syn_T, llr_prior(p))
        post = post.T
        return DecodeResult(e_hat=(post < 0.0).to(torch.int8), n_iter=n_iter,
                            converged=conv, posterior=post)


def make_seq_qc_decoder(st: QCStructure, cfg: DecoderConfig,
                        layers: Optional[LayerSchedule] = None, device="cpu",
                        kind: str = "MS") -> SeqQCDecoder:
    return SeqQCDecoder(st, cfg, layers=layers, device=device, kind=kind)


def make_ms_seq_qc_decoder(st, cfg, layers=None, device="cpu"):
    return SeqQCDecoder(st, cfg, layers=layers, device=device, kind="MS")


def make_bp_seq_qc_decoder(st, cfg, layers=None, device="cpu"):
    return SeqQCDecoder(st, cfg, layers=layers, device=device, kind="BP")
