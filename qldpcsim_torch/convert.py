"""Carry the reference's state into the port.

The system has no weights. What defines a run is the code (Hx/Hz, shared
through `codes` and `data/*.npy`), the static tables derived from it, and the
PRNG key state. This module turns the reference's representations of the
last two into the port's:

  * `keys_from_reference` — numpy uint32 key words (as `jax.random` keys are
    stored) -> the port's int64 key tensors;
  * `qc_tables_from_reference` — the reference's `QCStructure` and
    block-row layer groups -> the QC min-sum decoder's shift and group tables.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np
import torch

from qldpcsim_torch.ops.qc import QCStructure


def keys_from_reference(keys: np.ndarray,
                        device: Union[str, torch.device] = "cpu"
                        ) -> torch.Tensor:
    """(..., 2) uint32 key words -> (..., 2) int64 tensor of the same words."""
    a = np.asarray(keys)
    if a.dtype != np.uint32 or a.ndim < 1 or a.shape[-1] != 2:
        raise ValueError(f"expected (..., 2) uint32 keys, got {a.shape} "
                         f"{a.dtype}")
    return torch.as_tensor(a.astype(np.int64), device=device)


@dataclasses.dataclass(frozen=True)
class QCTables:
    """Static tables of the QC min-sum decoder.

    Block-row i owns edge slots row_ptr[i] .. row_ptr[i+1]-1; slot k
    connects it to variable block slot_j[k] through the cyclic shift
    slot_s[k] (check row r of the block-row meets variable
    slot_j[k] * L + (r + slot_s[k]) % L). Layer group g is block-rows
    group_ptr[g] .. group_ptr[g+1]-1; group_snap[g] is 1 when two of its
    block-rows share a variable block, so the group must read a posterior
    snapshot taken at its start (when they share none, reading the live
    posterior gives the same numbers, and the snapshot is skipped).
    """

    L: int
    n_b: int
    row_ptr: np.ndarray     # (m_b + 1,) int32
    slot_j: np.ndarray      # (S,) int32
    slot_s: np.ndarray      # (S,) int32
    group_ptr: np.ndarray   # (G + 1,) int32
    group_snap: np.ndarray  # (G,) int32

    @property
    def m_b(self) -> int:
        return self.row_ptr.shape[0] - 1

    @property
    def n(self) -> int:
        return self.n_b * self.L

    @property
    def m(self) -> int:
        return self.m_b * self.L

    @property
    def n_slots(self) -> int:
        return int(self.row_ptr[-1])

    @property
    def max_deg(self) -> int:
        return int(np.diff(self.row_ptr).max(initial=0))

    def gather_index(self, i: int) -> np.ndarray:
        """(deg_i, L) flat variable index read by block-row i, slot by slot."""
        k0, k1 = int(self.row_ptr[i]), int(self.row_ptr[i + 1])
        r = np.arange(self.L)
        return np.stack([self.slot_j[k] * self.L
                         + (r + self.slot_s[k]) % self.L
                         for k in range(k0, k1)]).reshape(k1 - k0, self.L)


def qc_tables_from_reference(st: QCStructure,
                             layer_groups: Sequence[Sequence[int]]
                             ) -> QCTables:
    """Build the decoder's tables from `QCStructure.blocks_of_row` and the
    block-row groups of `block_groups_of_layers` (or [[0..m_b-1]] for the
    flooding schedule). Groups must be contiguous runs covering the
    block-rows in order, as the reference's layerizer makes them."""
    groups: List[List[int]] = [list(map(int, g)) for g in layer_groups]
    flat = [i for g in groups for i in g]
    if flat != list(range(st.m_b)) or any(
            g != list(range(g[0], g[0] + len(g))) for g in groups if g):
        raise ValueError("layer groups must be contiguous block-row runs "
                         f"covering 0..{st.m_b - 1} in order, got {groups}")
    groups = [g for g in groups if g]
    row_ptr = [0]
    slot_j: List[int] = []
    slot_s: List[int] = []
    for i in range(st.m_b):
        for j, s in st.blocks_of_row(i):
            slot_j.append(j)
            slot_s.append(s % st.L)
        row_ptr.append(len(slot_j))
    group_ptr = [0]
    group_snap = []
    for g in groups:
        group_ptr.append(g[-1] + 1)
        blocks = [j for i in g for j, _ in st.blocks_of_row(i)]
        group_snap.append(int(len(blocks) != len(set(blocks))))
    i32 = np.int32
    return QCTables(L=int(st.L), n_b=int(st.n_b),
                    row_ptr=np.asarray(row_ptr, i32),
                    slot_j=np.asarray(slot_j, i32),
                    slot_s=np.asarray(slot_s, i32),
                    group_ptr=np.asarray(group_ptr, i32),
                    group_snap=np.asarray(group_snap, i32))
