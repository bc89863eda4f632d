"""Monte-Carlo engine: per-p shot pipeline, event classification, results.

Port of `qldpcsim_tpu/engine`: channel sampling -> batched decode ->
matmul-based classification -> integer counters.
"""

from qldpcsim_torch.engine.classify import ClassifierStatic, classify_batch
from qldpcsim_torch.engine.montecarlo import (
    ShotPipeline,
    SimConfig,
    simulate,
    simulate_p,
    simulate_sweep,
)
from qldpcsim_torch.engine.results import PPointResult, format_results_table

__all__ = [
    "ClassifierStatic",
    "classify_batch",
    "ShotPipeline",
    "SimConfig",
    "simulate_p",
    "simulate",
    "simulate_sweep",
    "PPointResult",
    "format_results_table",
]
