"""GF(2) linear algebra.

Host-side (NumPy, bit-packed uint64 word-parallel) routines used for static
preprocessing: rank, RREF, nullspace and logical operators. The port's own
copy of `qldpcsim_tpu/gf2` (`dense.py`, `logical.py`). The JAX package
dispatches its eliminations to a C++ core and quietly falls back to numpy
when that core is not built; the port takes the numpy path alone, with no
dispatch and no fallback (it runs once per `ShotPipeline`, on the host, and
gives the same pivots and bases).

Reference parity: qLDPCsim/gf2math.py:12-244 (rank, REF, nullSpace, rowBasis,
systematic_form) plus the deleted `logical_ops_css` capability (SURVEY.md §2.6).
The implementations here are fresh, word-parallel designs, not translations of
the reference's per-element Python loops.
"""

from qldpcsim_torch.gf2.dense import (
    pack_rows,
    unpack_rows,
    rank,
    ref,
    rref,
    null_space,
    row_basis,
    systematic_form,
    mat_mul,
    mat_vec,
)
from qldpcsim_torch.gf2.logical import logical_ops, css_k, check_css

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
