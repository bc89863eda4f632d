"""The benchmark's own tests (run with `python -m pytest portbench/tests`
from the root of a checkout; the repository's `tests/` does not collect
them). They run on the CPU, with the program's plain versions."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture(autouse=True, scope="session")
def _few_threads():
    import torch

    torch.set_num_threads(2)
    yield
