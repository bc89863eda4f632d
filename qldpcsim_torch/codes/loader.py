"""Parity-check-matrix file loading (reference parity: simulator.py:20-35).

Accepts .npy arrays or whitespace-separated 0/1 text; always reduces mod 2 and
casts to int8, exactly like the reference loader.
"""

from __future__ import annotations

import numpy as np

from qldpcsim_torch.codes.library import Code


def load_matrix(path: str) -> np.ndarray:
    """Load a binary matrix from .npy or whitespace 0/1 text (mod 2, int8)."""
    if path.endswith(".npy"):
        mat = np.load(path)
    else:
        rows = []
        with open(path, "rt") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rows.append([int(x) for x in line.split()])
        mat = np.array(rows, dtype=int)
    return (mat % 2).astype(np.int8)


def code_from_files(hx_path: str, hz_path: str, name: str = "custom") -> Code:
    """Build a Code from Hx/Hz files (the reference CLI's input mode)."""
    return Code(name=name, Hx=load_matrix(hx_path), Hz=load_matrix(hz_path))
