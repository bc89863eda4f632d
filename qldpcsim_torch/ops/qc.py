"""Quasi-cyclic (circulant-lifted) structure detection: the reference's
numpy-only module, reused (`qldpcsim_tpu.ops.qc` imports no jax)."""

from qldpcsim_tpu.ops.qc import (  # noqa: F401
    QCStructure,
    block_groups_of_layers,
    detect_qc,
    layers_align_blocks,
)

__all__ = ["QCStructure", "detect_qc", "block_groups_of_layers",
           "layers_align_blocks"]
