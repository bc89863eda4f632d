"""Result containers and the reference-style results table (port of
`qldpcsim_tpu/engine/results.py`: same fields, properties and table)."""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List


@dataclasses.dataclass
class PPointResult:
    p: float
    shots: int
    counters: Dict[str, int]
    avg_iterations_x: float
    avg_iterations_z: float
    wall_time_s: float = 0.0
    # Wall time excluding the first chunk (kernel builds land there); NaN
    # when the p-point ran as a single chunk.
    warm_time_s: float = float("nan")
    warm_shots: int = 0

    @property
    def qbler(self) -> float:
        """Reference qBLER: 1 - (exact + degen)/shots."""
        c = self.counters
        return 1.0 - (c["decSuccessExact"] + c["decSuccessDegen"]) / self.shots

    @property
    def qbler_honest(self) -> float:
        """Stabilizer-aware qBLER: 1 - successStabilizer/shots."""
        return 1.0 - self.counters["successStabilizer"] / self.shots

    @property
    def shots_per_s(self) -> float:
        return self.shots / self.wall_time_s if self.wall_time_s else float("nan")

    @property
    def shots_per_s_warm(self) -> float:
        """Steady-state throughput, first chunk excluded; NaN for
        single-chunk runs."""
        if self.warm_shots and self.warm_time_s == self.warm_time_s:
            return self.warm_shots / self.warm_time_s
        return float("nan")

    def to_dict(self) -> dict:
        return {
            "p": self.p,
            "shots": self.shots,
            **self.counters,
            "Avg_number_of_iterations_X": self.avg_iterations_x,
            "Avg_number_of_iterations_Z": self.avg_iterations_z,
            "qBLER": self.qbler,
            "qBLER_honest": self.qbler_honest,
            "wall_time_s": self.wall_time_s,
            "shots_per_s": self.shots_per_s,
            # None (valid strict JSON) instead of NaN for 1-chunk runs
            "warm_time_s": (self.warm_time_s
                            if self.warm_time_s == self.warm_time_s else None),
            "shots_per_s_warm": (self.shots_per_s_warm
                                 if self.shots_per_s_warm
                                 == self.shots_per_s_warm else None),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


def format_results_table(results: List[PPointResult]) -> str:
    """ASCII table in the reference's layout, with an honest-qBLER column."""
    lines = [
        "",
        "                             ===          SIMULATION RESULTS          ===",
        "",
        "   Depolarizing probability | qBlock error rate | qBLER (stab-aware) | "
        "Decoding failures (X,Z) | Average iterations (X,Z)",
        "----------------------------+-------------------+--------------------+"
        "-------------------------+---------------------------",
    ]
    for r in results:
        c = r.counters
        lines.append(
            f"         {r.p:10.2e}         |     {r.qbler:7.2e}      |"
            f"     {r.qbler_honest:7.2e}       |"
            f"       {c['DecFailures_X']:5},{c['DecFailures_Z']:5}       |"
            f"      {r.avg_iterations_x:5.2f}, {r.avg_iterations_z:5.2f}"
        )
    return "\n".join(lines)
