"""The benchmark of `qldpcsim_torch` on the H100 (`BENCHMARK.json` at the
root of the repository names its cells): `run.py` runs one cell, `rank.py`
one process of a cell over several cards, `harness.py` the set-up, window,
passes and result, `capture.py` and `spans.py` the wrappers on the measured
pipeline, `check.py` the comparison with the plain reference
(`reference/`), `yardstick.py` the fixed arithmetic, `metrics/` one reader
per per-layer metric, `readings.py` the readings the check's limits come
from. It imports nothing of JAX or of the JAX package."""
