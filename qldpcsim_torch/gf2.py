"""GF(2) linear algebra: the reference's numpy-only module, reused.

Host-side static preprocessing (rank, null spaces, logical operators) for the
classifier; `qldpcsim_tpu.gf2` imports no jax.
"""

from qldpcsim_tpu.gf2 import (  # noqa: F401
    check_css,
    css_k,
    logical_ops,
    mat_mul,
    mat_vec,
    null_space,
    pack_rows,
    rank,
    ref,
    row_basis,
    rref,
    systematic_form,
    unpack_rows,
)

__all__ = [
    "pack_rows",
    "unpack_rows",
    "rank",
    "ref",
    "rref",
    "null_space",
    "row_basis",
    "systematic_form",
    "mat_mul",
    "mat_vec",
    "logical_ops",
    "css_k",
    "check_css",
]
