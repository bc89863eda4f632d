"""Batched decode-event classification (port of
`qldpcsim_tpu/engine/classify.py`).

Counters, in the reference's order of tests:
  decSuccessExact  — decoded error equals the true error on both components;
  decSuccessDegen  — the reference-compatible "degenerate" test: the integer
                     overlap of the residual with H (no mod 2) is zero;
  DecFailures_X/Z  — the decoded syndrome mismatches the observed one;
  successStabilizer, logicalErrors_X/Z — honest classification of a residual
                     with zero syndrome as a stabilizer or a logical operator
                     (L r != 0 mod 2).

Both sides are one 0/1 matmul each against [H^T | L^T]. float32 holds the
integer overlap counts exactly (they stay far below 2^24), and a TF32 matmul
would too: its inputs are 0/1, and it accumulates in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from qldpcsim_torch import gf2


@dataclasses.dataclass(frozen=True)
class ClassifierStatic:
    """Static matrices for classifying one CSS code; HLz_T and HLx_T are the
    (n, m + k) float32 [H^T | L^T] blocks on the classifier's device."""

    Hx: np.ndarray
    Hz: np.ndarray
    Kx: np.ndarray  # null_space(Hx): r in rowspace(Hx) iff Kx r == 0
    Kz: np.ndarray  # null_space(Hz)
    Lx: np.ndarray
    Lz: np.ndarray
    HLz_T: torch.Tensor
    HLx_T: torch.Tensor

    @staticmethod
    def build(Hx: np.ndarray, Hz: np.ndarray, device="cpu"
              ) -> "ClassifierStatic":
        Hx = np.asarray(Hx) % 2
        Hz = np.asarray(Hz) % 2
        Lx, Lz = gf2.logical_ops(Hx, Hz)

        def block(H, L):
            return torch.as_tensor(np.concatenate([H.T, L.T], axis=1),
                                   dtype=torch.float32, device=device)

        return ClassifierStatic(
            Hx=Hx, Hz=Hz,
            Kx=gf2.null_space(Hx), Kz=gf2.null_space(Hz),
            Lx=Lx, Lz=Lz,
            HLz_T=block(Hz, Lz), HLx_T=block(Hx, Lx),
        )


def _odd(v: torch.Tensor) -> torch.Tensor:
    return v - 2.0 * torch.floor(v * 0.5) > 0.5


def classify_batch(st: ClassifierStatic, err_x, err_z, ex_hat, ez_hat,
                   sy_z, sy_x, valid: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
    """Classify one batch of decode outcomes; returns 0-d int64 counts on the
    batch's device. `valid` masks out padding shots of a partial chunk.

    Contract (as in the reference): sy_z == Hz err_x and sy_x == Hx err_z
    (mod 2), so a decoded-syndrome mismatch is an odd overlap of the residual
    with H, and the syndrome arguments are not read."""
    rx = err_x.to(torch.bool) ^ ex_hat.to(torch.bool)
    rz = err_z.to(torch.bool) ^ ez_hat.to(torch.bool)
    exact = (~rx.any(dim=-1)) & (~rz.any(dim=-1))

    mz, mx = st.Hz.shape[0], st.Hx.shape[0]
    ov_x = rx.to(torch.float32) @ st.HLz_T
    ov_z = rz.to(torch.float32) @ st.HLx_T
    ref_degen = (~exact) & (ov_x[:, :mz] == 0.0).all(dim=-1) \
        & (ov_z[:, :mx] == 0.0).all(dim=-1)

    undet_x = ~_odd(ov_x[:, :mz]).any(dim=-1)
    undet_z = ~_odd(ov_z[:, :mx]).any(dim=-1)
    fail_x = ~undet_x
    fail_z = ~undet_z
    if st.Lx.shape[0]:
        log_x = _odd(ov_x[:, mz:]).any(dim=-1) & undet_x
        log_z = _odd(ov_z[:, mx:]).any(dim=-1) & undet_z
    else:
        log_x = torch.zeros_like(undet_x)
        log_z = torch.zeros_like(undet_z)
    success_honest = undet_x & ~log_x & undet_z & ~log_z

    if valid is None:
        valid = torch.ones_like(exact)

    def _c(mask):
        return (mask & valid).sum()

    return {
        "decSuccessExact": _c(exact),
        "decSuccessDegen": _c(ref_degen),
        "DecFailures_X": _c(fail_x),
        "DecFailures_Z": _c(fail_z),
        "successStabilizer": _c(success_honest),
        "logicalErrors_X": _c(log_x),
        "logicalErrors_Z": _c(log_z),
    }
