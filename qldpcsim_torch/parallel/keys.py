"""Per-tile keys of the global tile stream (reference: `parallel/mesh.py`
`chunk_keys`).

RNG discipline as in the reference: seed -> p-index -> global tile. Tile t of
a p-point draws from `fold_in(key_p, t)`, so a run's counters do not depend on
how tiles are grouped into chunks.
"""

from __future__ import annotations

import torch

from qldpcsim_torch.utils.threefry import fold_in


def chunk_keys(key_p: torch.Tensor, chunk_start: int, n_parallel: int
               ) -> torch.Tensor:
    """(n_parallel, 2) int64 keys of global tiles chunk_start ..
    chunk_start + n_parallel - 1 (indices wrap at 2^32 like the reference's
    uint32 iota)."""
    idx = torch.arange(chunk_start, chunk_start + n_parallel,
                       dtype=torch.int64, device=key_p.device)
    return fold_in(key_p, idx)
