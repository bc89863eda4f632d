"""Constructors of (Hx, Hz) parity-check-matrix pairs for CSS codes.

Same code families as the reference (qLDPCsim/PCMlibrary.py:25-203):
Shor [[9,1,3]], Steane [[7,1,3]], MacKay bicycle, the QC-LDPC Tanner code
(L=31), and the lifted-product LP04/LP118 families of Panteleev–Kalachev.
Outputs are bit-identical to the reference constructors and to the
`data/*.npy` matrices (tests/test_torch_codes.py); the circulant lifting is
a vectorized scatter rather than the reference's per-block np.roll loop.

The port's own copy of `qldpcsim_tpu/codes/library.py` (numpy only): the port
imports nothing of the JAX package.

Exponent base matrices are published data:
  Tanner code     — IEEE TIT 10.1109/TIT.2004.838370 (powers of 2 mod 31)
  LP04 / LP118    — Quantum 6, 767 (2022), Tables (lifted-product codes)
  bicycle         — quant-ph/0304161 Fig. 9 perfect difference set, size 73
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Tuple

import numpy as np


@dataclass(frozen=True)
class Code:
    """A CSS code: X/Z parity-check matrices plus derived metadata."""

    name: str
    Hx: np.ndarray
    Hz: np.ndarray

    @property
    def n(self) -> int:
        return self.Hx.shape[1]

    @property
    def k(self) -> int:
        from qldpcsim_torch.gf2 import css_k

        return css_k(self.Hx, self.Hz)

    def __post_init__(self):
        object.__setattr__(self, "Hx", (np.asarray(self.Hx) % 2).astype(np.int8))
        object.__setattr__(self, "Hz", (np.asarray(self.Hz) % 2).astype(np.int8))
        if self.Hx.size and self.Hz.size and self.Hx.shape[1] != self.Hz.shape[1]:
            raise ValueError("Hx and Hz must have the same number of columns (physical qubits).")


def shor_code() -> Tuple[np.ndarray, np.ndarray]:
    """[[9,1,3]] Shor code: three 3-qubit repetition blocks in each basis
    (reference: PCMlibrary.py:25-48)."""
    n = 9
    # Z-checks: intra-block neighbour parities (0,1),(1,2) per 3-qubit block.
    Hz = np.zeros((6, n), dtype=np.int8)
    for blk in range(3):
        for j in range(2):
            Hz[2 * blk + j, 3 * blk + j] = 1
            Hz[2 * blk + j, 3 * blk + j + 1] = 1
    # X-checks: block-vs-block parities over whole blocks.
    Hx = np.zeros((2, n), dtype=np.int8)
    Hx[0, 0:6] = 1
    Hx[1, 3:9] = 1
    return Hx, Hz


def steane_code() -> Tuple[np.ndarray, np.ndarray]:
    """[[7,1,3]] Steane code: the [7,4,3] Hamming parity-check matrix for both
    bases (reference: PCMlibrary.py:51-62)."""
    H = np.array(
        [
            [1, 0, 0, 1, 0, 1, 1],
            [0, 1, 0, 1, 1, 0, 1],
            [0, 0, 1, 0, 1, 1, 1],
        ],
        dtype=np.int8,
    )
    return H.copy(), H.copy()


def bicycle_code() -> Tuple[np.ndarray, np.ndarray]:
    """MacKay bicycle code H = [C | C^T] from the size-73 perfect difference
    set {2,8,15,19,20,34,42,44,72} (reference: PCMlibrary.py:66-77)."""
    L = 73
    offsets = np.array([2, 8, 15, 19, 20, 34, 42, 44, 72])
    # C is circulant: row i has ones at columns (offsets + i) mod L.
    rows = np.repeat(np.arange(L), offsets.size)
    cols = ((offsets[None, :] + np.arange(L)[:, None]) % L).ravel()
    C = np.zeros((L, L), dtype=np.int8)
    C[rows, cols] = 1
    H = np.concatenate([C, C.T], axis=1)
    return H.copy(), H.copy()


def _lift_circulant(Bexp: np.ndarray, L: int) -> np.ndarray:
    """Expand an exponent base matrix into a binary PCM.

    Entry s >= 0 becomes the LxL circulant permutation x^s (ones at
    (a, (a+s) mod L)); entry -1 becomes the zero block. Vectorized scatter
    equivalent of the reference's per-block np.roll loop
    (PCMlibrary.py:88-97 / :129-138).
    """
    mb, nb = Bexp.shape
    H = np.zeros((mb * L, nb * L), dtype=np.int8)
    ii, jj = np.nonzero(Bexp >= 0)
    if ii.size:
        a = np.arange(L)
        rows = (ii[:, None] * L + a[None, :]).ravel()
        cols = (jj[:, None] * L + (a[None, :] + Bexp[ii, jj][:, None]) % L).ravel()
        H[rows, cols] = 1
    return H


def _lifted_product(B: np.ndarray, L: int) -> Tuple[np.ndarray, np.ndarray]:
    """Hypergraph/lifted-product base construction shared by the Tanner and LP
    families (reference: PCMlibrary.py:105-112 and :195-202):

        Btc = L - B^T
        Bx  = [ (B+1) (x) I_nb , I_mb (x) (Btc+1) ] - 1
        Bz  = [ I_nb (x) (B+1) , (Btc+1) (x) I_mb ] - 1

    where -1 entries mark zero blocks and the Kronecker identity factors place
    blocks on diagonals.
    """
    B = np.asarray(B, dtype=np.int64)
    Btc = L - B.T
    mb, nb = B.shape
    Bx = np.concatenate(
        [np.kron(B + 1, np.eye(nb, dtype=np.int64)), np.kron(np.eye(mb, dtype=np.int64), Btc + 1)],
        axis=1,
    ) - 1
    Bz = np.concatenate(
        [np.kron(np.eye(nb, dtype=np.int64), B + 1), np.kron(Btc + 1, np.eye(mb, dtype=np.int64))],
        axis=1,
    ) - 1
    return _lift_circulant(Bx, L), _lift_circulant(Bz, L)


def qc_ldpc_tanner_code() -> Tuple[np.ndarray, np.ndarray]:
    """QC-LDPC Tanner code, L=31, base = powers of 2 mod 31
    (reference: PCMlibrary.py:81-113)."""
    L = 31
    B = np.array(
        [
            [1, 2, 4, 8, 16],
            [5, 10, 20, 9, 18],
            [25, 19, 7, 14, 28],
        ],
        dtype=np.int64,
    )
    return _lifted_product(B, L)


# Lifted-product exponent tables from Quantum 6, 767 (2022)
# (reference: PCMlibrary.py:142-191). Keys: (family, index) -> (L, dmin, B).
_LP_TABLES: Dict[Tuple[str, int], Tuple[int, int, np.ndarray]] = {
    ("LP04", 0): (7, 10, np.array([[0, 0, 0, 0], [0, 1, 2, 5], [0, 6, 3, 1]])),
    ("LP04", 1): (9, 12, np.array([[0, 0, 0, 0], [0, 1, 6, 7], [0, 4, 5, 2]])),
    ("LP04", 2): (17, 18, np.array([[0, 0, 0, 0], [0, 1, 2, 11], [0, 8, 12, 13]])),
    ("LP04", 3): (19, 20, np.array([[0, 0, 0, 0], [0, 2, 6, 9], [0, 16, 7, 11]])),
    ("LP118", 0): (16, 12, np.array([[0, 0, 0, 0, 0], [0, 2, 4, 7, 11], [0, 3, 10, 14, 15]])),
    ("LP118", 1): (21, 16, np.array([[0, 0, 0, 0, 0], [0, 4, 5, 7, 17], [0, 14, 18, 12, 11]])),
    ("LP118", 2): (30, 20, np.array([[0, 0, 0, 0, 0], [0, 2, 14, 24, 25], [0, 16, 11, 14, 13]])),
}


def qc_ldpc_lifted_code(family: str = "LP04", index: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Lifted-product LP04/LP118 codes (reference: PCMlibrary.py:120-203)."""
    key = (family, index)
    if family not in ("LP04", "LP118"):
        raise ValueError("qc_ldpc_lifted_code: unrecognized code family.")
    if key not in _LP_TABLES:
        raise ValueError(f"qc_ldpc_lifted_code: index out of bounds for code family {family}.")
    L, _dmin, B = _LP_TABLES[key]
    return _lifted_product(B, L)


def _registry() -> Dict[str, Callable[[], Tuple[np.ndarray, np.ndarray]]]:
    reg: Dict[str, Callable[[], Tuple[np.ndarray, np.ndarray]]] = {
        "shor": shor_code,
        "steane": steane_code,
        "bicycle": bicycle_code,
        "tanner": qc_ldpc_tanner_code,
    }
    for fam in ("LP04", "LP118"):
        count = 4 if fam == "LP04" else 3
        for idx in range(count):
            reg[f"{fam.lower()}_{idx}"] = (
                lambda fam=fam, idx=idx: qc_ldpc_lifted_code(fam, idx)
            )
    return reg


CODE_REGISTRY = _registry()


def get_code(name: str) -> Code:
    """Look up a library code by registry name (shor, steane, bicycle, tanner,
    lp04_0..3, lp118_0..2)."""
    key = name.lower()
    if key not in CODE_REGISTRY:
        raise KeyError(f"Unknown code {name!r}; available: {sorted(CODE_REGISTRY)}")
    Hx, Hz = CODE_REGISTRY[key]()
    return Code(name=key, Hx=Hx, Hz=Hz)
