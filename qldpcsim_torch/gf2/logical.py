"""Logical operator bases for CSS codes.

Restores the capability of the reference's deleted `logical_ops_css` /
`logical_ops_from_checks` modules (SURVEY.md §2.6): compute logical X/Z
operator bases from (Hx, Hz) via GF(2) nullspace / rowspace cosets. The live
reference lumps stabilizer-equivalent and logical mismatches together
(reference landmine: simulator.py:296-298) — these bases enable the honest
stabilizer-vs-logical event classification in qldpcsim_torch.engine.classify.
The port's own copy of `qldpcsim_tpu/gf2/logical.py` (numpy only).
"""

from __future__ import annotations

import numpy as np

from qldpcsim_torch.gf2.dense import (
    _eliminate_packed,
    mat_mul,
    null_space,
    pack_rows,
    rank,
    row_basis,
    unpack_rows,
)


def css_k(Hx: np.ndarray, Hz: np.ndarray) -> int:
    """Number of logical qubits k = n - rank(Hx) - rank(Hz)
    (reference: simulator.py:76)."""
    n = Hx.shape[1] if Hx.size else Hz.shape[1]
    return n - rank(Hx) - rank(Hz)


def check_css(Hx: np.ndarray, Hz: np.ndarray) -> bool:
    """CSS orthogonality: Hx @ Hz.T == 0 (mod 2)."""
    if Hx.size == 0 or Hz.size == 0:
        return True
    return not mat_mul(Hx, Hz.T).any()


def _quotient_basis(kernel_basis: np.ndarray, subspace_basis: np.ndarray) -> np.ndarray:
    """Rows of kernel_basis completing subspace_basis to a basis of the kernel.

    Greedy, as the reference: keep each kernel row that is independent of the
    subspace and of the rows kept before it. Whether a row is independent
    does not depend on the basis the span is held in, so the span is held as
    a reduced echelon basis (packed words, one pivot column per row) and each
    candidate is reduced against it in one word-parallel pass; the reference
    re-eliminates the whole stack per candidate and keeps the same rows.
    """
    n = kernel_basis.shape[1] if kernel_basis.size else subspace_basis.shape[1]
    W = max(1, -(-n // 64))
    span = np.zeros((subspace_basis.shape[0] + kernel_basis.shape[0], W),
                    dtype=np.uint64)
    piv_w = np.zeros(span.shape[0], dtype=np.int64)      # pivot word per row
    piv_b = np.zeros(span.shape[0], dtype=np.uint64)     # pivot bit per row
    r = 0
    if subspace_basis.size:
        R = pack_rows(subspace_basis)
        piv, r = _eliminate_packed(R, n, reduced=True)
        span[:r] = R[:r]
        piv_w[:r] = np.asarray(piv, dtype=np.int64) >> 6
        piv_b[:r] = np.asarray(piv, dtype=np.uint64) & np.uint64(63)
    kept = []
    one = np.uint64(1)
    for v in kernel_basis:
        x = pack_rows(v[None, :])[0]
        # rows of the span whose pivot column is set in x (the span is
        # reduced: no row has another row's pivot, so x's bits decide)
        hit = ((x[piv_w[:r]] >> piv_b[:r]) & one).astype(bool)
        if hit.any():
            x = x ^ np.bitwise_xor.reduce(span[:r][hit], axis=0)
        nz = np.nonzero(x)[0]
        if nz.size == 0:
            continue
        kept.append(v)
        w = int(nz[0])
        b = np.uint64(int(x[w] & (~x[w] + one)).bit_length() - 1)
        sel = ((span[:r, w] >> b) & one).astype(bool)
        span[:r][sel] ^= x
        span[r], piv_w[r], piv_b[r] = x, w, b
        r += 1
    if not kept:
        return np.zeros((0, n), dtype=np.uint8)
    return np.asarray(kept, dtype=np.uint8)


def logical_ops(Hx: np.ndarray, Hz: np.ndarray):
    """Logical X and Z operator bases for a CSS code.

    Returns (Lx, Lz), each (k, n) uint8 with
      Hz @ Lx.T == 0,  Lx not in rowspace(Hx)   (X-type logicals)
      Hx @ Lz.T == 0,  Lz not in rowspace(Hz)   (Z-type logicals)
    paired so that (Lx @ Lz.T) % 2 == I_k (symplectic pairing).
    """
    Hx = np.asarray(Hx) % 2
    Hz = np.asarray(Hz) % 2
    Lx = _quotient_basis(null_space(Hz), Hx)
    Lz = _quotient_basis(null_space(Hx), Hz)
    k = Lx.shape[0]
    assert Lz.shape[0] == k, "CSS structure violated: |Lx| != |Lz|"
    if k == 0:
        return Lx, Lz
    # Symplectic pairing: make P = Lx Lz^T the identity by row-reducing P and
    # applying the same transforms to the operator bases. P is invertible over
    # GF(2) because Lx/Lz are dual quotient bases.
    P = mat_mul(Lx, Lz.T)
    # Invert P: eliminate [P | I] -> [I | P^-1].
    aug = np.concatenate([P, np.eye(k, dtype=np.uint8)], axis=1)
    R = pack_rows(aug)
    piv, _ = _eliminate_packed(R, 2 * k, reduced=True)
    aug_r = unpack_rows(R, 2 * k)
    assert len([p for p in piv if p < k]) == k, "pairing matrix singular"
    Pinv = aug_r[:, k:]
    Lx = mat_mul(Pinv, Lx).astype(np.uint8)
    assert (mat_mul(Lx, Lz.T) == np.eye(k, dtype=np.int64)).all()
    return Lx, Lz
