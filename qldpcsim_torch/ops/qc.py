"""Quasi-cyclic (circulant-lifted) structure detection.

Every library code except Shor/Steane is circulant-lifted
(reference PCMlibrary.py:88-97 `expand_base`: exponent s -> roll(I_L, s,
axis=1), s = -1 -> zero block; bicycle_code's circulant is the L=n/2 special
case). The QC decoder kernels exploit this: a block-row's check-to-
variable gather is a static cyclic shift of the variable block, so message
passing needs no gathers and no incidence matmuls at all.

The port's own copy of `qldpcsim_tpu/ops/qc.py` (numpy only).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class QCStructure:
    """H == lift(shifts, L): H[iL:(i+1)L, jL:(j+1)L] = roll(I_L, shifts[i,j])
    (shift -1 = zero block)."""

    L: int
    shifts: np.ndarray            # (m_b, n_b) int, -1 for zero blocks

    @property
    def m_b(self) -> int:
        return self.shifts.shape[0]

    @property
    def n_b(self) -> int:
        return self.shifts.shape[1]

    @property
    def m(self) -> int:
        return self.m_b * self.L

    @property
    def n(self) -> int:
        return self.n_b * self.L

    def blocks_of_row(self, i: int):
        """[(var_block j, shift s), ...] for block-row i."""
        return [(j, int(s)) for j, s in enumerate(self.shifts[i]) if s >= 0]


def detect_qc(H: np.ndarray, L: Optional[int] = None) -> Optional[QCStructure]:
    """Detect circulant-lifted structure; returns None if H is not QC for
    any admissible lift size (or the given L)."""
    H = (np.asarray(H) % 2).astype(np.int8)
    m, n = H.shape
    if L is not None:
        cands = [L]
    else:
        # try divisors of gcd(m, n), largest first (smallest base matrix)
        g = int(np.gcd(m, n))
        cands = [d for d in range(g, 1, -1) if g % d == 0]
    for Lc in cands:
        st = _try_L(H, Lc)
        if st is not None:
            return st
    return None


def _try_L(H: np.ndarray, L: int) -> Optional[QCStructure]:
    m, n = H.shape
    if L < 2 or m % L or n % L:
        return None
    m_b, n_b = m // L, n // L
    shifts = np.full((m_b, n_b), -1, dtype=np.int64)
    base = np.arange(L)
    for i in range(m_b):
        for j in range(n_b):
            sub = H[i * L:(i + 1) * L, j * L:(j + 1) * L]
            if not sub.any():
                continue
            if sub.sum() != L:
                return None
            cols = sub.argmax(axis=1)
            s = int(cols[0])
            if not (sub[base, (base + s) % L] == 1).all():
                return None
            shifts[i, j] = s
    return QCStructure(L=L, shifts=shifts)


def block_groups_of_layers(layers, st: QCStructure):
    """Map a layer schedule onto block-row groups, or None if impossible.

    The greedy contiguous layerizer (reference simulator.py:212-224) merges
    adjacent conflict-free block-rows into one layer, so each layer is a
    contiguous run of whole block-rows [aL, bL). Returns
    [[block-rows of layer 0], [..1], ...] covering 0..m_b-1 in order.
    """
    groups = []
    nxt = 0
    for li in range(layers.n_layers):
        size = int(layers.sizes[li])
        if size == 0:
            continue
        rows = layers.rows[li, :size]
        a, b = int(rows[0]), int(rows[-1]) + 1
        if (size != b - a or a != nxt * st.L or b % st.L
                or not (rows == np.arange(a, b)).all()):
            return None
        groups.append(list(range(a // st.L, b // st.L)))
        nxt = b // st.L
    if nxt != st.m_b:
        return None
    return groups


def layers_align_blocks(layers, st: QCStructure) -> bool:
    """True iff the layer schedule maps onto whole block-rows."""
    return block_groups_of_layers(layers, st) is not None
