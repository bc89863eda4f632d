"""Dense GF(2) linear algebra over bit-packed uint64 words (host-side NumPy).

These are the static-preprocessing routines of the framework: ranks and
logical-qubit counts (reference: qLDPCsim/gf2math.py:91-135), row-echelon
forms with transform matrices (gf2math.py:139-187), nullspaces
(gf2math.py:12-50), row bases (gf2math.py:57-87), and systematic forms
(gf2math.py:191-244).

Design: rows are packed 64 columns per uint64 lane so a row elimination is a
word-parallel XOR over ~n/64 words applied to all selected rows at once via
NumPy fancy indexing — O(n · m·n/64) instead of the reference's per-element
Python loops. All public functions accept/return plain 0/1 integer arrays.

The port's own copy of `qldpcsim_tpu/gf2/dense.py`. `rank` and
`_eliminate_packed` dispatch to the native C++ core (`native.py`, over
`csrc/gf2core.cpp`) when it is built and `QLDPC_NATIVE` is not "0", and
otherwise run the numpy elimination below; both give the same pivots, ranks
and bases.
"""

from __future__ import annotations

import numpy as np

_BITS = 64
_ONE = np.uint64(1)


def pack_rows(A: np.ndarray) -> np.ndarray:
    """Pack a (m, n) 0/1 matrix into (m, ceil(n/64)) uint64 words (LSB-first)."""
    A = (np.asarray(A, dtype=np.uint8) & 1)
    if A.ndim != 2:
        raise ValueError("pack_rows expects a 2D matrix")
    m, n = A.shape
    W = max(1, -(-n // _BITS))
    pad = W * _BITS - n
    if pad:
        A = np.concatenate([A, np.zeros((m, pad), dtype=np.uint8)], axis=1)
    bits = A.reshape(m, W, _BITS).astype(np.uint64)
    weights = _ONE << np.arange(_BITS, dtype=np.uint64)
    # Each term is a distinct power of two: the sum is an exact bitwise OR.
    return (bits * weights).sum(axis=2, dtype=np.uint64)


def unpack_rows(P: np.ndarray, n: int) -> np.ndarray:
    """Inverse of pack_rows: (m, W) uint64 -> (m, n) uint8."""
    P = np.asarray(P, dtype=np.uint64)
    m, W = P.shape
    shifts = np.arange(_BITS, dtype=np.uint64)
    bits = (P[:, :, None] >> shifts) & _ONE
    return bits.reshape(m, W * _BITS)[:, :n].astype(np.uint8)


def _eliminate_packed(R: np.ndarray, n: int, T: np.ndarray | None = None,
                      reduced: bool = True):
    """In-place Gaussian elimination on packed rows R.

    Returns (pivot_cols, row_count_used). If T is given it receives the same
    row operations (so T tracks the transform with R_out = T @ R_in mod 2).
    Dispatches to the native core when it is available.
    """
    from qldpcsim_torch.gf2.native import eliminate_native

    piv = eliminate_native(R, n, T, reduced)
    if piv is not None:
        return piv, len(piv)
    m = R.shape[0]
    pivots: list[int] = []
    row = 0
    for col in range(n):
        w = col >> 6
        mask = _ONE << np.uint64(col & 63)
        hits = np.nonzero((R[row:, w] & mask) != 0)[0]
        if hits.size == 0:
            continue
        piv = row + int(hits[0])
        if piv != row:
            R[[row, piv]] = R[[piv, row]]
            if T is not None:
                T[[row, piv]] = T[[piv, row]]
        sel = (R[:, w] & mask) != 0
        sel[row] = False
        if not reduced:
            sel[:row] = False
        if sel.any():
            R[sel] ^= R[row]
            if T is not None:
                T[sel] ^= T[row]
        pivots.append(col)
        row += 1
        if row == m:
            break
    return pivots, row


def rank(A: np.ndarray) -> int:
    """Rank of a binary matrix over GF(2) (reference: gf2math.py:91-135),
    on the native core when it is available."""
    A = np.asarray(A)
    if A.size == 0:
        return 0
    R = pack_rows(A)
    from qldpcsim_torch.gf2.native import rank_native

    r = rank_native(R, A.shape[1])
    if r is not None:
        return r
    pivots, _ = _eliminate_packed(R, A.shape[1], reduced=False)
    return len(pivots)


def ref(A: np.ndarray, reduced: bool = False):
    """Row-echelon form of A with transform matrix.

    Returns (B, T, pivots) with B = (T @ A) % 2 and pivots the pivot-column
    indices (reference: gf2math.py:139-187 returns only (B, T); the pivot list
    is an addition used by OSD and logical-operator extraction).
    """
    A = np.asarray(A)
    m, n = A.shape
    R = pack_rows(A)
    T = pack_rows(np.eye(m, dtype=np.uint8))
    pivots, _ = _eliminate_packed(R, n, T=T, reduced=reduced)
    return unpack_rows(R, n), unpack_rows(T, m), pivots


def rref(A: np.ndarray):
    """Reduced row-echelon form: (R, T, pivots) with R = (T @ A) % 2."""
    return ref(A, reduced=True)


def row_basis(M: np.ndarray) -> np.ndarray:
    """Basis of the row space of M, in row-echelon order
    (reference: gf2math.py:57-87)."""
    M = np.asarray(M)
    if M.size == 0:
        return np.zeros((0, M.shape[1] if M.ndim == 2 else 0), dtype=np.uint8)
    R = pack_rows(M)
    pivots, _ = _eliminate_packed(R, M.shape[1], reduced=True)
    r = len(pivots)
    if r == 0:
        return np.zeros((0, M.shape[1]), dtype=np.uint8)
    return unpack_rows(R[:r], M.shape[1])


def null_space(A: np.ndarray) -> np.ndarray:
    """Basis (rows) of the mod-2 nullspace of A (reference: gf2math.py:12-50).

    Returns a (n - rank, n) uint8 matrix K with (A @ K.T) % 2 == 0.
    """
    A = np.asarray(A)
    m, n = A.shape
    R = pack_rows(A)
    pivots, r = _eliminate_packed(R, n, reduced=True)
    Ru = unpack_rows(R[:r], n)
    piv_set = set(pivots)
    free_cols = [c for c in range(n) if c not in piv_set]
    K = np.zeros((len(free_cols), n), dtype=np.uint8)
    for i, f in enumerate(free_cols):
        K[i, f] = 1
        for j, p in enumerate(pivots):
            K[i, p] = Ru[j, f]
    return K


def systematic_form(H: np.ndarray):
    """Put a full-row-rank H (r x n) into [I_r | A] via column permutation.

    Returns (H_sys, perm) with H_sys == row_reduce(H)[:, perm]
    (reference: gf2math.py:191-244). Raises ValueError when H is row-rank
    deficient.
    """
    H = np.asarray(H)
    r, n = H.shape
    R = pack_rows(H)
    pivots, got = _eliminate_packed(R, n, reduced=True)
    if len(pivots) < r:
        raise ValueError("Matrix is not full-rank; cannot form systematic representation.")
    Ru = unpack_rows(R, n)
    perm = np.arange(n, dtype=np.int64)
    # Swap each pivot column into position i (mirrors the reference's
    # column-swap bookkeeping: every pivot lands on the diagonal).
    for i, p in enumerate(sorted_pivot_order(pivots)):
        # Find current location of original pivot column p.
        cur = int(np.nonzero(perm == p)[0][0])
        if cur != i:
            perm[[i, cur]] = perm[[cur, i]]
    return Ru[:, perm], perm


def sorted_pivot_order(pivots):
    """Pivot columns in elimination (row) order — already ascending."""
    return list(pivots)


def mat_mul(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """(A @ B) % 2 for 0/1 matrices."""
    return (np.asarray(A, dtype=np.int64) @ np.asarray(B, dtype=np.int64)) % 2


def mat_vec(A: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(A @ v) % 2 for a 0/1 matrix and vector(s)."""
    return (np.asarray(A, dtype=np.int64) @ np.asarray(v, dtype=np.int64)) % 2
