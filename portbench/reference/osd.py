"""Ordered-statistics decoding of order lambda (OSD-lambda) over GF(2), plain
numpy, for shots whose iterative decode did not converge.

Per shot:
  1. reliability of column j: max(q, 1 - q), q = 1 / (1 + exp(llr_j)) in
     float32, llr_j the posterior clipped to +-100; the columns in a stable
     ascending order of it (least reliable first);
  2. the basis: the first rank(H) columns in that order that are linearly
     independent of those chosen before them; the others are information
     positions;
  3. the information positions keep the iterative decode's hard decision;
     the basis positions solve H e = syndrome for it (unique, the basis
     columns being independent);
  4. the candidates flip every subset of the lambda information positions
     that come first in the order (pattern w flips position k when bit k of
     w is set, w = 0 .. 2^lambda - 1) and solve the basis again; the
     candidate of least Hamming weight wins, the lowest w on ties.

Vectorised over shots: the column-permuted H of every shot, with the
identity beside it, is reduced column by column; the identity part then maps
any syndrome to the values of the pivot columns.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import gf2

F32 = np.float32


def reliability_order(post: np.ndarray) -> np.ndarray:
    llr = np.clip(post.astype(F32), F32(-100.0), F32(100.0))
    q = F32(1.0) / (F32(1.0) + np.exp(llr))
    rel = np.maximum(q, F32(1.0) - q)
    return np.argsort(rel, axis=1, kind="stable")


def _words(bits: np.ndarray) -> np.ndarray:
    """(..., k) 0/1 -> (..., ceil(k / 64)) uint64, bit c of word c // 64."""
    k = bits.shape[-1]
    pad = (-k) % 64
    if pad:
        bits = np.concatenate(
            [bits, np.zeros(bits.shape[:-1] + (pad,), bits.dtype)], axis=-1)
    packed = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    return packed.view(np.uint64)


def osd(H: np.ndarray, order: int, e_hat: np.ndarray, syn: np.ndarray,
        post: np.ndarray) -> np.ndarray:
    """(B, n) uint8 estimates of OSD-`order` for B shots."""
    H = (np.asarray(H) % 2).astype(np.uint8)
    rank = gf2.rank(H)
    m, n = H.shape
    B = e_hat.shape[0]
    if B == 0:
        return np.zeros((0, n), dtype=np.uint8)
    perm = reliability_order(post)                        # (B, n)
    # rows: the permuted H, then the identity (m x m)
    Hp = np.transpose(H[:, perm], (1, 0, 2))             # (B, m, n)
    eye = np.broadcast_to(np.eye(m, dtype=np.uint8), (B, m, m))
    A = _words(np.concatenate([Hp, eye], axis=2))        # (B, m, W)
    pivoted = np.zeros((B, m), dtype=bool)
    pivot_row = np.full((B, n), -1, dtype=np.int64)
    bidx = np.arange(B)
    for c in range(n):
        if pivoted.sum(axis=1).min() == rank:
            break
        w, b = divmod(c, 64)
        bit = ((A[:, :, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)
        cand = bit & ~pivoted
        has = cand.any(axis=1)
        if not has.any():
            continue
        piv = np.argmax(cand, axis=1)
        prow = A[bidx, piv]                                # (B, W)
        hit = bit & has[:, None]
        hit[bidx, piv] = False
        A ^= np.where(hit[:, :, None], prow[:, None, :], np.uint64(0))
        pivoted[bidx[has], piv[has]] = True
        pivot_row[bidx[has], c] = piv[has]
    sel = pivot_row >= 0                                   # basis positions
    # the identity part: E with E H_basis = rows of the reduced form
    E = np.unpackbits(A.view(np.uint8), axis=2, bitorder="little")[
        :, :, n:n + m]                                     # (B, m, m)

    e_perm = np.take_along_axis(e_hat.astype(np.uint8), perm, axis=1)
    e_info_perm = np.where(sel, 0, e_perm).astype(np.uint8)
    e_info = np.zeros_like(e_perm)
    np.put_along_axis(e_info, perm, e_info_perm, axis=1)
    s0 = (syn.astype(np.int64)
          + e_info.astype(np.int64) @ H.T.astype(np.int64)) & 1   # (B, m)

    info_rank = np.cumsum(~sel, axis=1)
    flip_pos = [np.argmax(info_rank == k + 1, axis=1) for k in range(order)]
    flip_col = [H[:, perm[bidx, fp]].T for fp in flip_pos]          # (B, m)
    flip_bit = [e_perm[bidx, fp].astype(np.int64) for fp in flip_pos]
    base_w = e_info_perm.sum(axis=1).astype(np.int64)

    best = best_x = best_pat = None
    prow_of = np.where(sel, pivot_row, 0)
    for pat in range(2 ** order):
        s = s0.copy()
        w_info = base_w.copy()
        for k in range(order):
            if (pat >> k) & 1:
                s ^= flip_col[k]
                w_info += 1 - 2 * flip_bit[k]
        t = np.einsum("bij,bj->bi", E.astype(np.int64), s) & 1    # (B, m)
        x = np.where(sel, np.take_along_axis(t, prow_of, axis=1), 0)
        weight = x.sum(axis=1) + w_info
        if best is None:
            best, best_x = weight, x
            best_pat = np.zeros(B, dtype=np.int64)
        else:
            better = weight < best
            best = np.where(better, weight, best)
            best_x = np.where(better[:, None], x, best_x)
            best_pat = np.where(better, pat, best_pat)
    flips = np.zeros_like(e_perm)
    for k in range(order):
        on = ((best_pat >> k) & 1).astype(bool)
        flips[bidx[on], flip_pos[k][on]] = 1
    out_perm = np.where(sel, best_x, e_perm ^ flips).astype(np.uint8)
    out = np.zeros_like(out_perm)
    np.put_along_axis(out, perm, out_perm, axis=1)
    return out
