"""GF(2) linear algebra.

Host-side (NumPy, bit-packed uint64 word-parallel) routines used for static
preprocessing: rank, RREF, nullspace and logical operators. The port's own
copy of `qldpcsim_tpu/gf2` (`dense.py`, `logical.py`, `native.py`). As in
the JAX package, the eliminations and the rank dispatch to the native C++
core (`native.py`, `csrc/gf2core.cpp`, built with g++ on first use;
`QLDPC_NATIVE=0` turns it off). Where it cannot be built, the first call
warns with the compiler's error and the numpy path runs, which gives the
same pivots, ranks and bases. It runs when a `ShotPipeline` is built, on
the host.

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
