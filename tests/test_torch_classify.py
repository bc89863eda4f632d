"""The port's classification counters equal the reference's classify_batch
on identical inputs: exact decodes, stabilizer and logical residuals,
detected failures, and a partial valid mask."""

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.engine.classify import ClassifierStatic as RefStatic
from qldpcsim_tpu.engine.classify import classify_batch as ref_classify

from qldpcsim_torch.engine.classify import ClassifierStatic, classify_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _residuals(rng, n, B, stab, logical):
    """B residual rows: zero, a stabilizer, a logical operator, a
    stabilizer times a logical, or random noise, in turns."""
    out = np.zeros((B, n), np.int64)
    for b in range(B):
        kind = b % 5
        s = stab[rng.integers(stab.shape[0])] * rng.integers(0, 2)
        if kind == 1:
            out[b] = stab[rng.integers(stab.shape[0])]
        elif kind == 2:
            out[b] = logical[rng.integers(logical.shape[0])]
        elif kind == 3:
            out[b] = (logical[rng.integers(logical.shape[0])] + s) % 2
        elif kind == 4:
            out[b] = rng.random(n) < 0.05
    return out.astype(np.int8)


@pytest.mark.parametrize("code", ["steane", "lp04_0", "lp118_0"])
@pytest.mark.parametrize("n_valid", [None, 61])
def test_counters_equal_reference(code, n_valid):
    rng = np.random.default_rng(17)
    c = get_code(code)
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    ref_st = RefStatic.build(Hx, Hz)
    st = ClassifierStatic.build(Hx, Hz)
    n, B = Hx.shape[1], 100
    err_x = (rng.random((B, n)) < 0.05).astype(np.int8)
    err_z = (rng.random((B, n)) < 0.05).astype(np.int8)
    # X residuals: stabilizers are rows of Hx, logicals rows of Lx
    ex_hat = err_x ^ _residuals(rng, n, B, Hx, ref_st.Lx)
    ez_hat = err_z ^ np.roll(_residuals(rng, n, B, Hz, ref_st.Lz), 5, axis=0)
    sy_z = ((err_x.astype(np.int64) @ Hz.T) % 2).astype(np.float32)
    sy_x = ((err_z.astype(np.int64) @ Hx.T) % 2).astype(np.float32)
    valid = None if n_valid is None else np.arange(B) < n_valid
    ref = ref_classify(ref_st, err_x.astype(bool), err_z.astype(bool),
                       ex_hat, ez_hat, sy_z, sy_x, valid=valid)
    out = classify_batch(
        st, torch.from_numpy(err_x), torch.from_numpy(err_z),
        torch.from_numpy(ex_hat), torch.from_numpy(ez_hat),
        torch.from_numpy(sy_z), torch.from_numpy(sy_x),
        valid=None if valid is None else torch.from_numpy(valid))
    got = {k: int(v) for k, v in out.items()}
    assert got == {k: int(v) for k, v in ref.items()}
    # every kind of event occurs
    for k in ("decSuccessExact", "DecFailures_X", "DecFailures_Z",
              "successStabilizer", "logicalErrors_X", "logicalErrors_Z"):
        assert got[k] > 0, k


def test_static_matrices_equal_reference():
    c = get_code("lp04_0")
    ref = RefStatic.build(c.Hx, c.Hz)
    st = ClassifierStatic.build(c.Hx, c.Hz)
    for name in ("Hx", "Hz", "Kx", "Kz", "Lx", "Lz"):
        assert np.array_equal(getattr(ref, name), getattr(st, name)), name
    assert st.HLz_T.shape == (175, 84 + ref.Lz.shape[0])
