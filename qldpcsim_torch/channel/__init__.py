"""Depolarizing channel and syndrome extraction."""

from qldpcsim_torch.channel.depolarizing import (
    sample_depolarizing,
    sample_shot_tiles,
    syndromes_of,
)

__all__ = ["sample_depolarizing", "sample_shot_tiles", "syndromes_of"]
