"""CSS code library and loaders: the reference's numpy-only module, reused.

`qldpcsim_tpu.codes` imports no jax (its package loads lazily), so the port
shares the one code library and the `data/*.npy` matrices with it.
"""

from qldpcsim_tpu.codes import (  # noqa: F401
    CODE_REGISTRY,
    Code,
    bicycle_code,
    code_from_files,
    get_code,
    load_matrix,
    qc_ldpc_lifted_code,
    qc_ldpc_tanner_code,
    shor_code,
    steane_code,
)

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
