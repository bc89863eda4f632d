"""The engine side of the port's parity harness (`qldpcsim_torch/utils/
parity.py::engine_qbler` on the CPU) against the JAX package's
`benchmarks/parity.py::engine_qbler`, row by row at a small shot count:
equal qBLER for the MS, BF and NG rows, within 4 sigma for BP (tanh and log
round differently in XLA and torch)."""

import importlib.util
import math
from pathlib import Path

import pytest
import torch

from qldpcsim_tpu.codes import get_code as ref_get_code

from qldpcsim_torch.codes import get_code
from qldpcsim_torch.utils import parity

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_parity():
    """The JAX package's `benchmarks/parity.py` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_parity", ROOT / "benchmarks" / "parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _shots(row):
    # the serial decoders walk Tanner's 465 rows one at a time on the CPU
    return 128 if row.code == "tanner" else 256


@pytest.mark.parametrize("row", parity.ROWS, ids=lambda r: r.name)
def test_engine_equals_the_jax_harness(jax_parity, row):
    shots = _shots(row)
    args = (row.p, shots, row.dec_type, row.iters, row.schedule,
            row.osd_order, 0, row.bf_residual)
    q, _ = parity.engine_qbler(get_code(row.code), *args, device="cpu")
    q_ref, _ = jax_parity.engine_qbler(ref_get_code(row.code), *args)
    if row.dec_type == "BP":
        pool = (q + q_ref) / 2
        sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
        assert abs(q - q_ref) <= 4 * sigma, (q, q_ref)
    else:
        assert q == q_ref
    assert 0.0 < q < 1.0


def test_warm_rate_of_a_run_of_several_chunks():
    """The rate leaves the first chunk out: a float over two chunks, NaN
    over one."""
    code = get_code("bicycle")
    q2, rate2 = parity.engine_qbler(code, 0.02, 8192, "BF", 50, "F", -1, 0,
                                    device="cpu")
    q1, rate1 = parity.engine_qbler(code, 0.02, 4096, "BF", 50, "F", -1, 0,
                                    device="cpu")
    assert rate2 > 0 and rate1 != rate1
