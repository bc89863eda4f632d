"""Shot sharding over slots and processes, counter reduction, multi-process
initialisation, and the key layout of the shot stream (port of
`qldpcsim_tpu/parallel`)."""

from qldpcsim_torch.parallel.mesh import (
    make_mesh,
    chunk_keys,
    multihost_init,
)

__all__ = ["make_mesh", "chunk_keys", "multihost_init"]
