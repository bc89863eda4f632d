"""Message passing over an arbitrary H: CUDA kernel E (`csrc/general_h.cu`),
its wrapper, its plain PyTorch version, and the decoder module around them,
for two check-node kinds.

Replaces the TPU kernel `qldpcsim_tpu/ops/general_h_pallas.py::
make_gh_decoder` (kinds "MS" and "BP"): the whole decode of a shot block in
one launch over any parity-check matrix whose layers are contiguous runs of
check rows (the flooding schedule's one layer of all rows; the greedy
layerizer's layers). The TPU kernel gathers the posterior at each edge's
variable and scatters the message deltas back with two one-hot matrix
products, because gathers are slow on that machine; here the gather is an
indexed load through `var_of` and the scatter an indexed add, and the
incidence matrices are never built. It computes what that kernel computes,
in the same float32 order of operations. Edges are check-major, every check
row padded to dmax slots. Per shot:

  post[v] = L_ch, c2v = 0
  for it, for layer (check rows a .. b-1), for row i, for slot k with a
  variable v = var_of[i, k]:
    V   = post[v] - c2v[i, k]       (post as it stood at the layer's start)
    MS: m1/m2 = running min / second min of |V| over the row's slots
              (strict `a < m1`), 1e30 -> 0
        par = neg_par - 2 floor(neg_par / 2)
        new = (((beta * ss) * (1 - 2 par)) * (1 - 2 (V < 0))) * mag,
              mag = m2 where |V| == m1 else m1
    BP: t    = sgn(tanh(V * 0.5)) * max(|tanh(V * 0.5)|, 1e-12)   per slot
        prod = sgn(prod * t) * max(|prod * t|, 1e-30)              running
        th2  = clip(prod / t, -(1 - eps), 1 - eps)
        new  = ss * log((1 + th2) / (1 - th2))
    delta = new - c2v[i, k];  c2v[i, k] <- new
  after the layer's rows: post[v] += sum of the deltas of v's edges in the
  layer, in ascending edge order
  after the iteration's layers: a shot whose hard decision reproduces the
  syndrome latches n_iter = it + 1 and is frozen

with ss = 1 - 2 syn[i]. Pad slots take no part: the reference gives them
magnitude 1e30, sign 0 and tanh 1, which leave the row's minima, parity and
product as they are. When no two rows of a layer meet one variable (the
greedy layerizer's layers) each posterior entry receives one delta per
layer, `post + delta` is exact whatever the order, and updating the
posterior in place equals the reference's product. Where rows of a layer
share variables (the flooding schedule) the reference's product sums a
variable's deltas in an order of its own; kernel and plain version sum them
in ascending edge order from 0 and add the sum to the posterior.

Shots never interact, so the kernel gives each shot its own thread, which
leaves its loop at the iteration where it latches; the plain version runs
all shots together and keeps a latched shot's messages, so that its deltas
are 0, as the reference does.

`general_h` runs the kernel for CUDA tensors and the plain version for CPU
tensors. `LAUNCHES[kind]` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch import nn

from qldpcsim_torch.convert import (
    GHTables,
    _contiguous_layer_runs,
    gh_tables_from_reference,
)
from qldpcsim_torch.decoders.common import (
    DecodeResult,
    DecoderConfig,
    LayerSchedule,
    TannerGraph,
)
from qldpcsim_torch.ops import _build
from qldpcsim_torch.ops.ms_qc_cuda import KINDS, llr_prior
from qldpcsim_torch.ops.seq_qc_cuda import _two_smallest

LAUNCHES = {kind: 0 for kind in KINDS}

_BIG = 1e30  # stand-in for +inf in the min reductions, as in the reference


def supports(H: np.ndarray, layers: Optional[LayerSchedule]) -> bool:
    """Shape and schedule gate of the general-H decoder: contiguous layers
    and at least one edge. The reference also bounds the size of its
    incidence matrices by the TPU's fast memory; the port builds none, and
    keeps its state, (m * dmax + 2 n) float32 per shot, in device memory, so
    it sets no bound: a batch whose state does not fit fails to allocate."""
    H = np.asarray(H) % 2
    m = H.shape[0]
    if _contiguous_layer_runs(layers, m) is None:
        return False
    return bool(m) and int(H.sum(axis=1).max()) > 0


def general_h_plain(dec: "GHDecoder", syn_T: torch.Tensor, lch: float):
    """Plain PyTorch version. syn_T: (m, B) float32 0/1 on dec's device.
    Returns posterior (n, B) float32, n_iter (B,) int32, converged (B,)
    bool."""
    tabs = dec.tabs
    dmax, B = tabs.dmax, syn_T.shape[1]
    dev = syn_T.device
    f32 = torch.float32
    post = torch.full((tabs.n, B), lch, dtype=f32, device=dev)
    c2v = torch.zeros((tabs.n_edges, B), dtype=f32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iter = torch.full((B,), dec.max_iter, dtype=torch.int32, device=dev)
    ss_all = 1.0 - 2.0 * syn_T                           # (m, B)
    for it in range(dec.max_iter):
        if bool(done.all()):
            break
        active = ~done
        for li, (a, b) in enumerate(tabs.runs):
            cl = b - a
            padm = getattr(dec, f"pad{li}")              # (cl, dmax, 1) bool
            Cl = c2v[a * dmax:b * dmax]                  # (cl * dmax, B)
            pos = post[getattr(dec, f"gidx{li}")].view(cl, dmax, B)
            V = torch.where(padm, 0.0, pos) - Cl.view(cl, dmax, B)
            ss = ss_all[a:b]                             # (cl, B)
            if dec.kind == "MS":
                A = torch.where(padm, _BIG, V.abs())
                neg = torch.where(padm, 0.0, (V < 0.0).to(f32))
                npar = neg.sum(dim=1)
                m1, m2 = _two_smallest(A, dim=1)
                par = npar - 2.0 * torch.floor(npar * 0.5)
                coef = (dec.beta * ss) * (1.0 - 2.0 * par)
                mag = torch.where(A == m1[:, None], m2[:, None], m1[:, None])
                new = (coef[:, None] * (1.0 - 2.0 * neg)) * mag
            else:
                t = torch.tanh(V * 0.5)
                t = torch.where(t < 0.0, -1.0, 1.0) * torch.clamp_min(
                    t.abs(), 1e-12)
                t = torch.where(padm, 1.0, t)
                prod = t[:, 0]
                for k in range(1, dmax):
                    prod = prod * t[:, k]
                    prod = torch.where(prod < 0.0, -1.0, 1.0) \
                        * torch.clamp_min(prod.abs(), 1e-30)
                th2 = torch.clamp(prod[:, None] / t, -dec.clamp, dec.clamp)
                new = ss[:, None] * torch.log((1.0 + th2) / (1.0 - th2))
            new = torch.where(padm, 0.0, new).view(cl * dmax, B)
            new = torch.where(active, new, Cl)
            delta = new - Cl
            c2v[a * dmax:b * dmax] = new
            # each variable of the layer: the deltas of its edges summed in
            # ascending edge order (a zero row appended to `delta` stands
            # for "no further edge"), then one add into the posterior
            eidx = getattr(dec, f"eidx{li}")             # (nv, c) edge index
            delta = torch.cat([delta, delta.new_zeros((1, B))])
            acc = delta[eidx[:, 0]]
            for c in range(1, eidx.shape[1]):
                acc = acc + delta[eidx[:, c]]
            vidx = getattr(dec, f"vidx{li}")             # (nv,) variables
            post[vidx] = post[vidx] + acc
        est = torch.remainder(dec.H @ (post < 0.0).to(f32), 2.0)
        ok = (est == syn_T).all(dim=0)
        n_iter = torch.where(ok & ~done, it + 1, n_iter)
        done = done | ok
    return post, n_iter, done


def general_h_cuda(dec: "GHDecoder", syn_T: torch.Tensor, lch: float):
    """Kernel E: the contract of `general_h_plain`, on the card."""
    tabs = dec.tabs
    if syn_T.dtype != torch.float32 or syn_T.dim() != 2 \
            or syn_T.shape[0] != tabs.m or not syn_T.is_contiguous():
        raise ValueError(f"syn_T must be contiguous ({tabs.m}, B) float32, "
                         f"got {tuple(syn_T.shape)} {syn_T.dtype}")
    if dec.var_of.device != syn_T.device:
        raise ValueError(f"decoder tables on {dec.var_of.device}, "
                         f"syndromes on {syn_T.device}")
    B = syn_T.shape[1]
    dev = syn_T.device
    lib = _build.load("general_h")
    fn = lib.general_h_decode
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_float] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 9)
    post = torch.empty((tabs.n, B), dtype=torch.float32, device=dev)
    n_iter = torch.empty(B, dtype=torch.int32, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    c2v, acc = dec.scratch(B, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(syn_T.data_ptr(), B, KINDS.index(dec.kind), lch, dec.beta,
            dec.clamp, dec.max_iter, tabs.m, tabs.n, tabs.dmax,
            len(tabs.run_shared),
            dec.var_of.data_ptr(), dec.run_ptr.data_ptr(),
            dec.run_shared.data_ptr(), c2v.data_ptr(),
            None if acc is None else acc.data_ptr(), post.data_ptr(),
            n_iter.data_ptr(), conv.data_ptr(), stream)
    _build.check(lib, "general_h", rc)
    LAUNCHES[dec.kind] += 1
    return post, n_iter, conv


def general_h(dec: "GHDecoder", syn_T: torch.Tensor, lch: float):
    """Decode (m, B) float32 syndromes: the kernel for CUDA tensors, the
    plain version for CPU tensors. Returns posterior (n, B), n_iter (B,)
    int32, converged (B,) bool."""
    if syn_T.is_cuda:
        return general_h_cuda(dec, syn_T, lch)
    if syn_T.device.type == "cpu":
        return general_h_plain(dec, syn_T, lch)
    raise ValueError(f"unsupported device {syn_T.device}")


class GHDecoder(nn.Module):
    """decode(syndromes, p) -> DecodeResult over any H whose layers are
    contiguous runs of check rows (the reference's `make_gh_decoder`), kind
    MS or BP, schedule F (one run of all rows, whatever `layers` says) or L.

    Static tables live as buffers on `device`; syndromes must lie on the
    same device. Batches of any size decode as they are. The kernel's
    message scratch, and the per-variable delta sums of layers whose rows
    share variables, are allocated once per decoder and grown to the largest
    batch seen.
    """

    def __init__(self, H: np.ndarray, cfg: DecoderConfig,
                 layers: Optional[LayerSchedule] = None, device="cpu",
                 kind: str = "MS"):
        super().__init__()
        self.kind = kind.upper()
        if self.kind not in KINDS:
            raise ValueError(f"the general-H decoder runs kinds {KINDS}, got "
                             f"{kind!r}")
        sched = cfg.schedule.upper()
        if sched not in ("F", "L"):
            raise ValueError("the general-H decoder supports schedules F "
                             "and L")
        H = (np.asarray(H) % 2).astype(np.int8)
        self.tabs: GHTables = gh_tables_from_reference(
            TannerGraph.build(H), layers if sched == "L" else None)
        self.beta = float(np.float32(cfg.beta))
        # BP clamp: 1 - eps in float64, as Python forms it in the reference,
        # then rounded to float32
        self.clamp = float(np.float32(1.0 - float(cfg.eps)))
        self.max_iter = int(cfg.max_iter)
        self._scratch = None
        t = self.tabs
        for name in ("var_of", "run_ptr", "run_shared"):
            self.register_buffer(name, torch.as_tensor(
                getattr(t, name), dtype=torch.int32, device=device))
        # plain version: H for the per-iteration check and, per layer, the
        # gather index and pad mask of its edge block, the variables it
        # meets and each one's edges (offsets into the block; the block's
        # length stands for "no edge")
        self.register_buffer("H", torch.as_tensor(
            H, dtype=torch.float32, device=device))
        for li, (a, b) in enumerate(t.runs):
            blk = t.var_of[a:b].reshape(-1)
            vidx = np.unique(blk[blk >= 0])
            edges = [np.nonzero(blk == v)[0] for v in vidx]
            eidx = np.full((vidx.size, max(e.size for e in edges)), blk.size)
            for q, e in enumerate(edges):
                eidx[q, :e.size] = e
            for nm, arr, dt in (
                    (f"gidx{li}", np.maximum(blk, 0), torch.int64),
                    (f"pad{li}", (t.var_of[a:b] < 0)[:, :, None], torch.bool),
                    (f"vidx{li}", vidx, torch.int64),
                    (f"eidx{li}", eidx, torch.int64)):
                self.register_buffer(nm, torch.as_tensor(
                    np.ascontiguousarray(arr), dtype=dt, device=device))

    def scratch(self, B: int, device):
        """The kernel's state for B shots: c2v (m * dmax, B) float32 and,
        when a layer's rows share variables, the delta sums (n, B) float32
        (else None): views of buffers kept on the decoder."""
        t = self.tabs
        need = (t.n_edges * B, t.n * B if t.run_shared.any() else 0)
        s = self._scratch
        if s is None or s[0].device != device or s[0].numel() < need[0]:
            s = tuple(torch.empty(k, dtype=torch.float32, device=device)
                      for k in need)
            self._scratch = s
        return (s[0][:need[0]].view(t.n_edges, B),
                s[1][:need[1]].view(t.n, B) if need[1] else None)

    def forward(self, syndromes: torch.Tensor, p) -> DecodeResult:
        syn_T = syndromes.to(torch.float32).T.contiguous()
        post, n_iter, conv = general_h(self, syn_T, llr_prior(p))
        post = post.T
        return DecodeResult(e_hat=(post < 0.0).to(torch.int8), n_iter=n_iter,
                            converged=conv, posterior=post)


def make_gh_decoder(H: np.ndarray, cfg: DecoderConfig,
                    layers: Optional[LayerSchedule] = None, device="cpu",
                    kind: str = "MS") -> GHDecoder:
    return GHDecoder(H, cfg, layers=layers, device=device, kind=kind)
