"""Key layout of the shot stream (one process, one device in this slice)."""

from qldpcsim_torch.parallel.keys import chunk_keys

__all__ = ["chunk_keys"]
