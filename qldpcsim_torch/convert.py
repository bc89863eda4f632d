"""Carry the reference's state into the port.

The system has no weights. What defines a run is the code (Hx/Hz, shared
through `codes` and `data/*.npy`), the static tables derived from it, and the
PRNG key state. This module turns the reference's representations of the
last two into the port's:

  * `keys_from_reference` — numpy uint32 key words (as `jax.random` keys are
    stored) -> the port's int64 key tensors;
  * `qc_tables_from_reference` — the reference's `QCStructure` and
    block-row layer groups -> the QC decoder's shift and group tables;
  * `seq_qc_tables_from_reference` — the reference's `QCStructure` -> the
    serial (row-sequential) QC decoder's tables: the shift tables plus, per
    variable block, the block-rows that meet it;
  * `osd_static_from_reference` — the reference's `OSDStatic` (packed
    columns of H, rank) -> the OSD post-decoder's tensors;
  * `gh_tables_from_reference` — the reference's `TannerGraph` and
    `LayerSchedule` (read through `row_vars`, `row_mask`, `rows`, `sizes`,
    so the port's own serve alike) -> the general-H decoder's edge table
    and layer runs.

`QCStructure` is read through `L`, `m_b`, `n_b` and `blocks_of_row` only, so
the reference's and the port's own (`ops/qc.py`) serve alike.
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


@dataclasses.dataclass(frozen=True)
class SeqQCTables(QCTables):
    """Static tables of the serial (row-sequential) QC decoder: `QCTables`
    with one group per block-row, plus the column view the incremental
    syndrome upkeep needs. Variable block j is met by the block-rows
    col_i[k] through the shifts col_s[k], k = col_ptr[j] .. col_ptr[j+1]-1,
    in block-row order (the reference's `col_blocks[j]`): variable
    j * L + v sits in check row col_i[k] * L + (v - col_s[k]) % L.
    row_par[i] is the parity of block-row i's row weight. The c2v message
    of slot k, check row r is row k * L + r of the message state (block-row
    i's offset is row_ptr[i] * L, the reference's `offs[i]`)."""

    col_ptr: np.ndarray     # (n_b + 1,) int32
    col_i: np.ndarray       # (S,) int32
    col_s: np.ndarray       # (S,) int32
    row_par: np.ndarray     # (m_b,) int32


def seq_qc_tables_from_reference(st: QCStructure) -> SeqQCTables:
    """Build the serial QC decoder's tables from `QCStructure.blocks_of_row`
    (natural row order: block-row by block-row, row by row)."""
    base = qc_tables_from_reference(st, [[i] for i in range(st.m_b)])
    col_blocks: List[List[tuple]] = [[] for _ in range(st.n_b)]
    for i in range(st.m_b):
        for j, s in st.blocks_of_row(i):
            col_blocks[j].append((i, s % st.L))
    col_ptr = np.cumsum([0] + [len(c) for c in col_blocks])
    flat = [pair for c in col_blocks for pair in c]
    i32 = np.int32
    return SeqQCTables(
        **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
        col_ptr=np.asarray(col_ptr, i32),
        col_i=np.asarray([i for i, _ in flat], i32),
        col_s=np.asarray([s for _, s in flat], i32),
        row_par=np.asarray(np.diff(base.row_ptr) % 2, i32))


@dataclasses.dataclass(frozen=True)
class GHTables:
    """Static tables of the general-H decoder. Edges are check-major with
    every check row padded to dmax slots: edge i * dmax + k joins check row i
    to variable var_of[i, k], or to nothing where var_of is -1. Layer l is
    the contiguous check rows run_ptr[l] .. run_ptr[l+1]-1; run_shared[l] is
    1 when two of its rows meet one variable, so that the layer must read
    the posterior as it stood at the layer's start and sum its deltas per
    variable before adding them (when they share none, updating the
    posterior in place gives the same numbers)."""

    n: int
    var_of: np.ndarray      # (m, dmax) int32, -1 pads
    run_ptr: np.ndarray     # (R + 1,) int32
    run_shared: np.ndarray  # (R,) int32

    @property
    def m(self) -> int:
        return self.var_of.shape[0]

    @property
    def dmax(self) -> int:
        return self.var_of.shape[1]

    @property
    def n_edges(self) -> int:
        """Edge slots, pads included (the reference's E = m * dmax)."""
        return self.var_of.size

    @property
    def runs(self) -> List[tuple]:
        return [(int(a), int(b)) for a, b in zip(self.run_ptr[:-1],
                                                 self.run_ptr[1:])]

    @staticmethod
    def build(var_of: np.ndarray, n: int, runs: Sequence[tuple]
              ) -> "GHTables":
        var_of = np.ascontiguousarray(var_of, dtype=np.int32)
        shared = []
        for a, b in runs:
            vs = var_of[a:b][var_of[a:b] >= 0]
            shared.append(int(vs.size != np.unique(vs).size))
        return GHTables(n=int(n), var_of=var_of,
                        run_ptr=np.asarray([0] + [b for _, b in runs],
                                           np.int32),
                        run_shared=np.asarray(shared, np.int32))


def _contiguous_layer_runs(layers, m: int):
    """[(row0, row1), ...] per non-empty layer, or None if any layer is not a
    contiguous ascending run, the runs covering 0..m-1 in order. No layers
    means one run of all rows."""
    if layers is None:
        return [(0, m)]
    runs = []
    nxt = 0
    for li in range(layers.n_layers):
        size = int(layers.sizes[li])
        if size == 0:
            continue
        rows = layers.rows[li, :size]
        a, b = int(rows[0]), int(rows[-1]) + 1
        if a != nxt or size != b - a or not (rows == np.arange(a, b)).all():
            return None
        runs.append((a, b))
        nxt = b
    return runs if nxt == m else None


def gh_tables_from_reference(graph, layers=None) -> GHTables:
    """The general-H decoder's tables from a `TannerGraph` (`row_vars` with
    its pad value n, `row_mask`) and a `LayerSchedule` (`rows`, `sizes`;
    None = one layer of all rows, the flooding schedule). Raises ValueError
    when the layers are not contiguous runs covering the rows in order."""
    m, n = np.asarray(graph.H).shape
    mask = np.asarray(graph.row_mask)[:m]
    dmax = int(mask.sum(axis=1).max(initial=0))
    if dmax == 0:
        raise ValueError("the general-H decoder needs a check row with an "
                         "edge")
    runs = _contiguous_layer_runs(layers, m)
    if runs is None:
        raise ValueError("the general-H decoder needs contiguous layers "
                         "covering the check rows in order")
    var_of = np.where(mask, np.asarray(graph.row_vars)[:m], -1)[:, :dmax]
    return GHTables.build(var_of, n, runs)


@dataclasses.dataclass(frozen=True)
class OSDTables:
    """Static tensors of the OSD post-decoder: H is (m, n) of rank r; cols
    (n, mW) int32 holds column j of H packed LSB-first over the checks in
    32-bit words (the uint32 bits of the reference's `cols_packed`); rW
    words cover r tag bits."""

    m: int
    n: int
    r: int
    mW: int
    rW: int
    cols: torch.Tensor


def osd_static_from_reference(st, device: Union[str, torch.device] = "cpu"
                              ) -> OSDTables:
    """The reference's `OSDStatic` (or the port's, which has the same
    fields) -> `OSDTables` on `device`."""
    cols = np.ascontiguousarray(np.asarray(st.cols_packed))
    if cols.dtype != np.uint32 or cols.shape != (st.n, st.mW):
        raise ValueError(f"expected ({st.n}, {st.mW}) uint32 packed columns, "
                         f"got {cols.shape} {cols.dtype}")
    return OSDTables(m=int(st.m), n=int(st.n), r=int(st.r), mW=int(st.mW),
                     rW=int(st.rW),
                     cols=torch.as_tensor(cols.view(np.int32), device=device))
