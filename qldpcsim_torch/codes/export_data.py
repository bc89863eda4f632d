"""Write the `data/` parity-check matrix files from the constructors (port
of `qldpcsim_tpu/codes/export_data.py`).

The reference simulator ships its codes as `Hx_*/Hz_*.npy` pairs, and users
pass them with `--Hx/--Hz`. This writes the same stems, as int64, from this
package's own `codes/library.py`, plus the bicycle pair. The reference's
stale `*_5qb` pair (its 6 x 9 shape matches no constructor) is not written.

    python -m qldpcsim_torch.codes.export_data [outdir]   # default ./data
"""

from __future__ import annotations

import os
import sys

import numpy as np

from qldpcsim_torch.codes.library import (
    bicycle_code,
    qc_ldpc_lifted_code,
    qc_ldpc_tanner_code,
    shor_code,
    steane_code,
)

# stem -> constructor returning (Hx, Hz), named as the reference's data/
ASSETS = {
    "shor": shor_code,
    "steane": steane_code,
    "T": qc_ldpc_tanner_code,
    "LP04_0": lambda: qc_ldpc_lifted_code("LP04", 0),
    "LP04_1": lambda: qc_ldpc_lifted_code("LP04", 1),
    "LP04_2": lambda: qc_ldpc_lifted_code("LP04", 2),
    "LP04_3": lambda: qc_ldpc_lifted_code("LP04", 3),
    "LP118_0": lambda: qc_ldpc_lifted_code("LP118", 0),
    "LP118_1": lambda: qc_ldpc_lifted_code("LP118", 1),
    "LP118_2": lambda: qc_ldpc_lifted_code("LP118", 2),
    "bicycle": bicycle_code,
}


def export(outdir: str) -> list:
    """Write every pair into `outdir` (created if need be); the paths
    written, in order."""
    os.makedirs(outdir, exist_ok=True)
    written = []
    for stem, ctor in ASSETS.items():
        Hx, Hz = ctor()
        for pre, M in (("Hx", Hx), ("Hz", Hz)):
            path = os.path.join(outdir, f"{pre}_{stem}.npy")
            np.save(path, np.asarray(M, dtype=np.int64))
            written.append(path)
    return written


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    outdir = argv[0] if argv else os.path.join(os.getcwd(), "data")
    for path in export(outdir):
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
