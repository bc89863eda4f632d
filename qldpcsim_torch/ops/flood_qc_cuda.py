"""Slot-stacked flooding decode over a circulant-lifted H: CUDA kernel F
(`csrc/flood_qc.cu`), its wrapper and its plain PyTorch version, for two
check-node kinds.

Replaces the TPU kernel
`qldpcsim_tpu/ops/flood_qc_pallas.py::make_flood_stacked_kernel`, which the
reference's `make_qc_decoder` takes for schedule F with one convergence
check per iteration, a uniform block-row degree d and the opt-in
(`QLDPC_QC_STACKED=1`). All S = m_b * d slots update from one posterior
snapshot, v = roll(post[j], s) - c2v for every slot at once, then per check
row

  MS (normalized min-sum):
    m1/m2 = (min, second min) of |v| over the row's d slots by the pairwise
            merge tree ([0:h) with [h:2h), an odd leftover appended; on a
            tie both minima are kept), 1e30 -> 0
    par   = neg_par - 2 floor(neg_par / 2)
    c2v'  = ((beta * ss) * (1 - 2 par)) * (mag - 2 (neg * mag)),
            mag = m2 where |v| == m1 else m1
  BP (tanh-product sum-product):
    t     = sgn(tanh(v * 0.5)) * max(|tanh(v * 0.5)|, 1e-12)    per slot
    prod  = the product of the row's t by the same tree, each level's
            products clamped to sgn(q) * max(|q|, 1e-30)
    th2   = clip(prod / t, -(1 - eps), 1 - eps)
    c2v'  = ss * log((1 + th2) / (1 - th2))
  both:
    post[j] += (roll back(c2v' - c2v) summed over the slots that meet block
               j, in ascending slot order)          (frozen lanes: c2v' = c2v)

with ss = 1 - 2 syndrome, and one syndrome check per iteration. The tree and
the summed deltas are this kernel's own association: the per-slot kernel
(`ms_qc_cuda.py`) folds from the left and adds each delta to the posterior
by itself, so the two give equal decisions under MS but posteriors that
differ in the last bits, and under BP the same statistics.

The kernel gives each shot a thread block (a thread per check row, then a
thread per variable: two passes and two barriers per iteration, the
syndrome check fused into the next iteration's first pass) and leaves at
convergence; the plain version runs all shots together on (S, L, B) stacks,
masking converged lanes as the reference does. Both take shot-major
tensors: syndromes (B, m) in, posterior (B, n) out. `plan(tabs)` fixes the
block's threads from the tables when the decoder is built
(`QCDecoder.flood_threads`); the wrapper reads it and takes no override.

`flood_qc` runs the kernel for CUDA tensors and the plain version for CPU
tensors. `LAUNCHES[kind]` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import numpy as np
import torch

from qldpcsim_torch.convert import QCTables
from qldpcsim_torch.ops import _build

KINDS = ("MS", "BP")
LAUNCHES = {kind: 0 for kind in KINDS}

_BIG = 1e30  # stand-in for +inf in the min reductions, as in the reference
_KERNEL_MAX_DEG = 16      # largest block-row degree flood_qc.cu is built for
_MAX_SMEM = 232448        # shared memory one block can use on an H100
_MAX_THREADS = 1024       # threads of one block
_VARS_PER_THREAD = 3      # phase 2's variables a thread keeps in registers
# the C signature of flood_qc_decode: syn, B, kind; lch, beta, clamp;
# max_iter, L, m_b, n_b, deg, threads; the seven device pointers and the
# stream
ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_float] * 3 + [ctypes.c_int] * 6
            + [ctypes.c_void_p] * 8)


def uniform_degree(st):
    """The common block-row degree of a `QCStructure`, or None if the
    degrees differ (the reference's `uniform_degree`)."""
    degs = {len(st.blocks_of_row(i)) for i in range(st.m_b)}
    return degs.pop() if len(degs) == 1 else None


def smem_bytes(tabs: QCTables) -> int:
    """Shared memory the kernel needs for one shot's state and tables."""
    S = tabs.n_slots
    return 4 * (tabs.n + 2 * S * tabs.L + tabs.m) + 4 * (3 * S + tabs.n_b + 1)


def supports(st, tabs: QCTables) -> bool:
    """True when kernel F can decode this code: a uniform block-row degree
    within the degrees the kernel is built for, and one shot's state within
    a block's shared memory. Asked where the kernel is selected, on every
    device; a code beyond either limit goes to the per-slot kernel."""
    deg = uniform_degree(st)
    return (deg is not None and 1 <= deg <= _KERNEL_MAX_DEG
            and smem_bytes(tabs) <= _MAX_SMEM)


def plan(tabs: QCTables) -> int:
    """Threads per shot of kernel F: a thread per check row, and at least a
    third of n so that phase 2 takes at most 3 variables a thread from
    registers, in whole warps, at most 1024 (rows beyond take a second
    pass). 4 lanes per row, and a thread per variable, were slower on the
    card (PERF.md §6)."""
    work = max(tabs.m, -(-tabs.n // _VARS_PER_THREAD), 32)
    return min(_MAX_THREADS, -(-work // 32) * 32)


def stacked_tables(tabs: QCTables) -> dict:
    """The index tensors of the stacked formulation, as numpy arrays:
    `col_ptr`, `col_k` (the kernel's column view); `gidx` (S * L,): the
    variable each (slot, check row) reads; `back_idx`, `back_mask`
    (cw, n): for variable v the flat (slot, check row) of its c-th delta in
    ascending slot order, and whether it has one."""
    L = tabs.L
    col_ptr, col_k = tabs.col_slots()
    r = np.arange(L)
    gidx = np.concatenate([tabs.slot_j[k] * L + (r + tabs.slot_s[k]) % L
                           for k in range(tabs.n_slots)]).astype(np.int64)
    cw = int(np.diff(col_ptr).max(initial=0))
    back_idx = np.zeros((cw, tabs.n), np.int64)
    back_mask = np.zeros((cw, tabs.n), bool)
    for j in range(tabs.n_b):
        for c, k in enumerate(col_k[col_ptr[j]:col_ptr[j + 1]]):
            # roll back by the slot's shift: variable v of the block takes
            # the delta of check row (v - s) mod L
            back_idx[c, j * L:(j + 1) * L] = k * L + (r - tabs.slot_s[k]) % L
            back_mask[c, j * L:(j + 1) * L] = True
    return dict(col_ptr=col_ptr, col_k=col_k, gidx=gidx, back_idx=back_idx,
                back_mask=back_mask)


def _min12_tree(A: torch.Tensor):
    """(min1, min2) over axis 0 of A (d, ...) by the reference's pairwise
    merge tree, with its tie rule: on a1 == b1 the pair is (a1, min(a2,
    b1))."""
    d = A.shape[0]
    m1, m2 = A, torch.full_like(A, _BIG)
    while d > 1:
        h = d // 2
        a1, a2, b1, b2 = m1[:h], m2[:h], m1[h:2 * h], m2[h:2 * h]
        take_a = a1 <= b1
        n1 = torch.where(take_a, a1, b1)
        n2 = torch.where(take_a, torch.minimum(a2, b1), torch.minimum(b2, a1))
        if d % 2:
            n1 = torch.cat([n1, m1[2 * h:]])
            n2 = torch.cat([n2, m2[2 * h:]])
            h += 1
        m1, m2, d = n1, n2, h
    return m1[0], m2[0]


def _ms_stacked(V: torch.Tensor, beta: float, ss: torch.Tensor
                ) -> torch.Tensor:
    """Min-sum update of every check row at once: V (m_b, d, L, B), ss
    (m_b, 1, L, B) -> new messages (m_b, d, L, B)."""
    A = V.abs()
    NEG = (V < 0.0).to(torch.float32)
    neg_par = NEG.sum(dim=1, keepdim=True)
    m1, m2 = _min12_tree(A.transpose(0, 1))
    m1 = torch.where(m1 >= _BIG, 0.0, m1)[:, None]
    m2 = torch.where(m2 >= _BIG, 0.0, m2)[:, None]
    par = neg_par - 2.0 * torch.floor(neg_par * 0.5)
    coef = (beta * ss) * (1.0 - 2.0 * par)
    mag = torch.where(A == m1, m2, m1)
    return coef * (mag - 2.0 * (NEG * mag))


def _bp_stacked(V: torch.Tensor, clamp: float, ss: torch.Tensor
                ) -> torch.Tensor:
    """Tanh-product update of every check row at once (shapes as
    `_ms_stacked`), the product by the clamped pairwise tree."""
    T = torch.tanh(V * 0.5)
    T = torch.where(T < 0.0, -1.0, 1.0) * torch.clamp_min(T.abs(), 1e-12)
    P = T
    d = P.shape[1]
    while d > 1:
        h = d // 2
        q = P[:, :h] * P[:, h:2 * h]
        q = torch.where(q < 0.0, -1.0, 1.0) * torch.clamp_min(q.abs(), 1e-30)
        P = torch.cat([q, P[:, 2 * h:]], dim=1) if d % 2 else q
        d = h + d % 2
    th2 = torch.clamp(P / T, -clamp, clamp)
    return ss * torch.log((1.0 + th2) / (1.0 - th2))


def flood_qc_plain(dec, syn: torch.Tensor, lch: float):
    """Plain PyTorch version. syn: (B, m) float32 0/1 on dec's device.
    Returns posterior (B, n) float32, n_iter (B,) int32, converged (B,)
    bool."""
    tabs = dec.tabs
    L, S, m_b = tabs.L, tabs.n_slots, tabs.m_b
    d = S // m_b
    B = syn.shape[0]
    dev = syn.device
    f32 = torch.float32
    syn_T = syn.T.contiguous()                           # (m, B)
    ss = (1.0 - 2.0 * syn_T).view(m_b, 1, L, B)
    post = torch.full((tabs.n, B), lch, dtype=f32, device=dev)
    c2v = torch.zeros((S, L, B), dtype=f32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    n_iter = torch.full((B,), dec.max_iter, dtype=torch.int32, device=dev)
    has = dec.flood_back_mask[:, :, None]                # (cw, n, 1)
    for it in range(dec.max_iter):
        if bool(done.all()):
            break
        active = ~done
        V = (post[dec.flood_gidx].view(S, L, B) - c2v).view(m_b, d, L, B)
        if dec.kind == "MS":
            new = _ms_stacked(V, dec.beta, ss)
        else:
            new = _bp_stacked(V, dec.clamp, ss)
        new = torch.where(active, new.view(S, L, B), c2v)
        delta = (new - c2v).view(S * L, B)
        c2v = new
        if has.shape[0]:
            acc = delta[dec.flood_back_idx[0]]           # (n, B)
            for c in range(1, has.shape[0]):
                acc = torch.where(has[c], acc + delta[dec.flood_back_idx[c]],
                                  acc)
            post = torch.where(has[0], post + acc, post)
        est = torch.remainder(dec.H @ (post < 0.0).to(f32), 2.0)
        ok = (est == syn_T).all(dim=0)
        n_iter = torch.where(ok & ~done, it + 1, n_iter)
        done = done | ok
    return post.T.contiguous(), n_iter, done


def flood_qc_cuda(dec, syn: torch.Tensor, lch: float):
    """Kernel F: the contract of `flood_qc_plain`, on the card."""
    tabs = dec.tabs
    if syn.dtype != torch.float32 or syn.dim() != 2 \
            or syn.shape[1] != tabs.m or not syn.is_contiguous():
        raise ValueError(f"syn must be contiguous (B, {tabs.m}) float32, "
                         f"got {tuple(syn.shape)} {syn.dtype}")
    if dec.slot_j.device != syn.device:
        raise ValueError(f"decoder tables on {dec.slot_j.device}, "
                         f"syndromes on {syn.device}")
    deg = tabs.n_slots // tabs.m_b
    if not 1 <= deg <= _KERNEL_MAX_DEG:
        raise ValueError(f"block-row degree {deg} outside the kernel's "
                         f"1..{_KERNEL_MAX_DEG}")
    need = smem_bytes(tabs)
    if need > _MAX_SMEM:
        raise ValueError(f"one shot's state needs {need} bytes of shared "
                         f"memory, a block has {_MAX_SMEM}")
    B = syn.shape[0]
    dev = syn.device
    lib = _build.load("flood_qc")
    fn = lib.flood_qc_decode
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES
    post = torch.empty((B, tabs.n), dtype=torch.float32, device=dev)
    n_iter = torch.empty(B, dtype=torch.int32, device=dev)
    conv = torch.empty(B, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(syn.data_ptr(), B, KINDS.index(dec.kind), lch, dec.beta,
            dec.clamp, dec.max_iter, tabs.L, tabs.m_b, tabs.n_b, deg,
            dec.flood_threads, dec.slot_j.data_ptr(),
            dec.slot_s.data_ptr(), dec.flood_col_ptr.data_ptr(),
            dec.flood_col_k.data_ptr(),
            post.data_ptr(), n_iter.data_ptr(), conv.data_ptr(), stream)
    _build.check(lib, "flood_qc", rc)
    LAUNCHES[dec.kind] += 1
    return post, n_iter, conv


def flood_qc(dec, syn: torch.Tensor, lch: float):
    """Decode (B, m) float32 syndromes: the kernel for CUDA tensors, the
    plain version for CPU tensors. Returns posterior (B, n), n_iter (B,)
    int32, converged (B,) bool."""
    if syn.is_cuda:
        return flood_qc_cuda(dec, syn, lch)
    if syn.device.type == "cpu":
        return flood_qc_plain(dec, syn, lch)
    raise ValueError(f"unsupported device {syn.device}")
