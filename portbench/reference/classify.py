"""The classification of decode outcomes into the event counters.

For each shot the residuals are r_x = err_x + e_hat_x and r_z = err_z +
e_hat_z (mod 2). Over the valid shots:

  decSuccessExact    both residuals are zero;
  decSuccessDegen    not exact, and the integer overlaps Hz r_x and Hx r_z
                     are zero in every row (no mod 2);
  DecFailures_X / _Z Hz r_x / Hx r_z is odd in some row (the decoded
                     syndrome differs from the observed one);
  logicalErrors_X    Hz r_x is even everywhere and r_x is not in the row
                     space of Hx (an X logical operator); _Z likewise with
                     Hx r_z and the row space of Hz;
  successStabilizer  neither side fails nor is a logical error.

r is in the row space of H exactly when it is orthogonal to the null space
of H, which is how it is tested here.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.reference import gf2

EVENTS = ("decSuccessExact", "decSuccessDegen", "DecFailures_X",
          "DecFailures_Z", "successStabilizer", "logicalErrors_X",
          "logicalErrors_Z")


class Classifier:
    def __init__(self, Hx: np.ndarray, Hz: np.ndarray):
        self.Hx = (np.asarray(Hx) % 2).astype(np.float32)
        self.Hz = (np.asarray(Hz) % 2).astype(np.float32)
        self.Kx = gf2.null_space(Hx).astype(np.float32)
        self.Kz = gf2.null_space(Hz).astype(np.float32)

    def counts(self, err_x, err_z, ex_hat, ez_hat, valid) -> Dict[str, int]:
        rx = (np.asarray(err_x).astype(bool)
              ^ np.asarray(ex_hat).astype(bool)).astype(np.float32)
        rz = (np.asarray(err_z).astype(bool)
              ^ np.asarray(ez_hat).astype(bool)).astype(np.float32)
        exact = (rx.sum(1) == 0) & (rz.sum(1) == 0)
        ov_x = (rx @ self.Hz.T).astype(np.int64)
        ov_z = (rz @ self.Hx.T).astype(np.int64)
        degen = ~exact & (ov_x == 0).all(1) & (ov_z == 0).all(1)
        fail_x = (ov_x & 1).any(1)
        fail_z = (ov_z & 1).any(1)
        log_x = ~fail_x & ((rx @ self.Kx.T).astype(np.int64) & 1).any(1)
        log_z = ~fail_z & ((rz @ self.Kz.T).astype(np.int64) & 1).any(1)
        ok = ~fail_x & ~log_x & ~fail_z & ~log_z
        valid = np.asarray(valid).astype(bool)
        return {name: int((mask & valid).sum()) for name, mask in zip(
            EVENTS, (exact, degen, fail_x, fail_z, ok, log_x, log_z))}
