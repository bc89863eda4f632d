"""GF(2) linear algebra on dense 0/1 matrices (numpy, row reduction)."""

from __future__ import annotations

import numpy as np


def rref(A: np.ndarray):
    """(R, pivots): the reduced row echelon form of A over GF(2) and its
    pivot columns."""
    R = (np.asarray(A) % 2).astype(np.uint8).copy()
    m, n = R.shape
    pivots = []
    row = 0
    for col in range(n):
        if row == m:
            break
        hits = np.nonzero(R[row:, col])[0]
        if hits.size == 0:
            continue
        p = row + hits[0]
        if p != row:
            R[[row, p]] = R[[p, row]]
        others = np.nonzero(R[:, col])[0]
        others = others[others != row]
        R[others] ^= R[row]
        pivots.append(col)
        row += 1
    return R[:row], pivots


def rank(A: np.ndarray) -> int:
    return len(rref(A)[1])


def null_space(A: np.ndarray) -> np.ndarray:
    """A basis of {x : A x = 0} over GF(2), one vector per row."""
    R, pivots = rref(A)
    n = np.asarray(A).shape[1]
    free = [c for c in range(n) if c not in set(pivots)]
    basis = np.zeros((len(free), n), dtype=np.uint8)
    for i, f in enumerate(free):
        basis[i, f] = 1
        for r, pc in enumerate(pivots):
            basis[i, pc] = R[r, f]
    return basis
