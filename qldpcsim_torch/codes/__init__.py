"""CSS code library: parity-check-matrix constructors and loaders.

Reference parity: qLDPCsim/PCMlibrary.py:25-203 (constructors) and
qLDPCsim/simulator.py:20-35 (matrix loader). The port's own copy of
`qldpcsim_tpu/codes` (numpy only), without its `export_data.py`.
"""

from qldpcsim_torch.codes.library import (
    Code,
    shor_code,
    steane_code,
    bicycle_code,
    qc_ldpc_tanner_code,
    qc_ldpc_lifted_code,
    get_code,
    CODE_REGISTRY,
)
from qldpcsim_torch.codes.loader import load_matrix, code_from_files

__all__ = [
    "Code",
    "shor_code",
    "steane_code",
    "bicycle_code",
    "qc_ldpc_tanner_code",
    "qc_ldpc_lifted_code",
    "get_code",
    "CODE_REGISTRY",
    "load_matrix",
    "code_from_files",
]
