"""Shared decoder infrastructure: Tanner-graph edge layouts, check-node layer
schedules, and configuration/result containers.

Port of `qldpcsim_tpu/decoders/common.py` (host-side numpy, identical
results) without the jax pytree registration: `DecodeResult` is a plain
dataclass of torch tensors here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class TannerGraph:
    """Static structure of one parity-check matrix H (host-side numpy).

    Fields:
      H          — (m, n) int8 parity-check matrix
      row_vars   — (m+1, dmax) int32: variable index per check-row edge slot,
                   padded with n; row m is an all-pad dummy row
      row_mask   — (m+1, dmax) bool: valid edge slots
      var_rows   — (n, cmax) int32: check-row index per variable edge slot,
                   padded with m
      var_slots  — (n, cmax) int32: which dmax-slot of that row this edge is
      var_mask   — (n, cmax) bool
    """

    H: np.ndarray
    row_vars: np.ndarray
    row_mask: np.ndarray
    var_rows: np.ndarray
    var_slots: np.ndarray
    var_mask: np.ndarray

    @property
    def m(self) -> int:
        return self.H.shape[0]

    @property
    def n(self) -> int:
        return self.H.shape[1]

    @property
    def dmax(self) -> int:
        return self.row_vars.shape[1]

    @property
    def cmax(self) -> int:
        return self.var_rows.shape[1]

    @property
    def n_edges(self) -> int:
        return int(self.row_mask.sum())

    @staticmethod
    def build(H: np.ndarray) -> "TannerGraph":
        H = (np.asarray(H) % 2).astype(np.int8)
        m, n = H.shape
        row_deg = H.sum(axis=1).astype(np.int64)
        col_deg = H.sum(axis=0).astype(np.int64)
        dmax = max(1, int(row_deg.max()) if m else 1)
        cmax = max(1, int(col_deg.max()) if n else 1)

        row_vars = np.full((m + 1, dmax), n, dtype=np.int32)
        row_mask = np.zeros((m + 1, dmax), dtype=bool)
        slot_of_edge = np.zeros((m, n), dtype=np.int32)  # dense scratch
        for i in range(m):
            cols = np.nonzero(H[i])[0]
            row_vars[i, : cols.size] = cols
            row_mask[i, : cols.size] = True
            slot_of_edge[i, cols] = np.arange(cols.size)

        var_rows = np.full((n, cmax), m, dtype=np.int32)
        var_slots = np.zeros((n, cmax), dtype=np.int32)
        var_mask = np.zeros((n, cmax), dtype=bool)
        for j in range(n):
            rows = np.nonzero(H[:, j])[0]
            var_rows[j, : rows.size] = rows
            var_slots[j, : rows.size] = slot_of_edge[rows, j]
            var_mask[j, : rows.size] = True

        return TannerGraph(H=H, row_vars=row_vars, row_mask=row_mask,
                           var_rows=var_rows, var_slots=var_slots,
                           var_mask=var_mask)


def layerize(H: np.ndarray, serial: bool = False) -> List[np.ndarray]:
    """Greedy contiguous check-row partition (the reference's layerizer).

    A layer is a maximal contiguous row window in which no column is touched
    twice; `serial=True` forces one row per layer. Layers are emitted as
    half-open contiguous ranges.
    """
    H = np.asarray(H)
    m = H.shape[0]
    layers: List[np.ndarray] = []
    start = 0
    end = 1  # candidate exclusive end of the current window + 1
    while end <= m:
        window_conflict = H[start:end].sum(axis=0).max(initial=0) > 1
        if window_conflict or (serial and end > start + 1):
            layers.append(np.arange(start, end - 1))
            start = end - 1
        else:
            end += 1
    layers.append(np.arange(start, end - 1))
    return layers


@dataclasses.dataclass(frozen=True)
class LayerSchedule:
    """Padded layer-index arrays.

    rows[l, s] is the s-th check row of layer l, padded with m (the decoder's
    dummy message row).
    """

    rows: np.ndarray  # (n_layers, max_layer) int32
    sizes: np.ndarray  # (n_layers,) int32

    @property
    def n_layers(self) -> int:
        return self.rows.shape[0]

    @staticmethod
    def from_layers(layers: Sequence[np.ndarray], m: int) -> "LayerSchedule":
        layers = [np.asarray(l, dtype=np.int32) for l in layers]
        if not layers:
            layers = [np.zeros((0,), dtype=np.int32)]
        # Floor of 8 slots, as in the reference (its padded shapes are part
        # of the schedule's identity; row m has no edges, so padding is inert).
        max_layer = max(8, max(l.size for l in layers))
        rows = np.full((len(layers), max_layer), m, dtype=np.int32)
        sizes = np.zeros((len(layers),), dtype=np.int32)
        for li, l in enumerate(layers):
            rows[li, : l.size] = l
            sizes[li] = l.size
        return LayerSchedule(rows=rows, sizes=sizes)


def build_layers(H_decode: np.ndarray, schedule: str,
                 H_layerize: Optional[np.ndarray] = None) -> LayerSchedule:
    """Build the check-node schedule for decoding with H_decode.

    schedule: 'F' flooding (one layer, all checks), 'L' layered, 'S' serial.

    H_layerize: optional different matrix to derive layer boundaries from —
    the reference simulator's cross-wired layers, when compatibility mode is
    requested (`layer_compat`). By default layers derive from the matrix
    actually being decoded.
    """
    m = H_decode.shape[0]
    if schedule == "F":
        layers = [np.arange(m)]
    elif schedule in ("L", "S"):
        src = H_decode if H_layerize is None else H_layerize
        layers = layerize(src, serial=(schedule == "S"))
        if H_layerize is not None:
            # Cross-wired layers may index rows beyond H_decode's row count
            # for shape-mismatched codes: clip them.
            layers = [l[l < m] for l in layers]
    else:
        raise ValueError("Unrecognized decoder scheduling option.")
    return LayerSchedule.from_layers(layers, m)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoder configuration: the reference's fields that the port reads,
    with the reference's defaults."""

    dec_type: str = "MS"          # NG | BF | MS | BP
    max_iter: int = 99
    schedule: str = "F"           # F | L | S
    beta: float = 0.75            # MS normalization
    eps: float = 1e-6             # BP: extrinsic tanh clamped to 1 - eps
    bf_max_iter: int = 50         # BF iteration cap
    bf_residual: str = "mod2"     # BF residual: "mod2" (overlap parity, the
                                  # standard bit-flipping residual) | "bool"
                                  # (any overlap, the reference simulator's)
    round1_iters: int = 0         # two-round cascade head: 0 = auto stage
                                  # plan, -1 = no cascade
    compact_cap_frac: float = 0.125
    qc_check_every: str = "iter"  # QC decoder convergence-check granularity
    impl: str = "auto"            # decoder implementation: auto | edge (the
                                  # padded edge layout, global variable-node
                                  # refresh) | mxu (incidence products, lazy
                                  # v2c) | seq (row-sequential, serial
                                  # schedules) | qc (kernels B and D,
                                  # circulant-lifted H) | gh (kernel E, any H
                                  # with contiguous layers)


@dataclasses.dataclass
class DecodeResult:
    """Batched decode output (torch tensors).

    e_hat      — (B, n) int8 estimated error
    n_iter     — (B,) int32 iterations used (first iteration index at
                 convergence + 1, else max_iter)
    converged  — (B,) bool syndrome matched during iteration
    posterior  — (B, n) float32 posterior LLRs
    """

    e_hat: object
    n_iter: object
    converged: object
    posterior: object = None
