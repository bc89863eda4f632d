"""The port's channel LLR prior equals the reference's XLA float32
`jnp.log((1 - p) / max(p, 1e-9))` bit for bit over 10^4 float32 p, and its
float32 log equals XLA:CPU's over float32 inputs at large (the engine's and
the tests' p points: test_torch_ms_qc.py)."""

import jax
import jax.numpy as jnp
import numpy as np

from qldpcsim_torch.ops import ms_qc_cuda
from qldpcsim_torch.utils.f32math import fma_f32, xla_cpu_logf


def _reference_prior(q):
    """The reference decoder's prior (`ms_qc_pallas.py:441-442`), on a
    float32 array of p values."""
    q = jnp.asarray(q, jnp.float32)
    return np.asarray(jax.jit(
        lambda q: jnp.log((1.0 - q) / jnp.maximum(q, 1e-9)))(q))


def test_prior_equals_xla_over_10k_p():
    rng = np.random.default_rng(0)
    q = (10.0 ** rng.uniform(-5.0, np.log10(0.3), 10_000)).astype(np.float32)
    ref = _reference_prior(q)
    port = np.array([ms_qc_cuda.llr_prior(v) for v in q], np.float32)
    assert np.array_equal(port, ref)
    # the correctly rounded log, which the port used before, differs from
    # XLA's at about 2 % of these p: the test can see a one-ulp change
    rounded = np.array([np.float32(np.log(np.float64(
        (np.float32(1) - v) / np.maximum(v, np.float32(1e-9))))) for v in q])
    assert 0.005 < (rounded != ref).mean() < 0.05


def test_logf_equals_xla_over_float32_inputs():
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.uniform(0.0, 2.0, 4000), 10.0 ** rng.uniform(-30, 30, 4000),
        rng.uniform(1e3, 1e6, 4000)]).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.log)(x))
    port = np.array([xla_cpu_logf(v) for v in x], np.float32)
    assert np.array_equal(port, ref)
    special = np.array([0.0, -1.0, np.inf, np.nan, 1e-40], np.float32)
    got = np.array([xla_cpu_logf(v) for v in special], np.float32)
    assert got[0] == -np.inf and np.isnan(got[1]) and got[2] == np.inf
    assert np.isnan(got[3]) and np.isfinite(got[4])


def test_fma_rounds_once():
    # a*b + c with the product's low bits deciding the rounding: two
    # roundings (float32 product, then sum) give another answer
    a = np.float32(1.0 + 2.0 ** -12)
    c = np.float32(-1.0)
    assert fma_f32(a, a, c) == np.float32(2.0 ** -11 + 2.0 ** -24)
    assert a * a + c != fma_f32(a, a, c)
    rng = np.random.default_rng(2)
    for a, b, c in rng.standard_normal((2000, 3)).astype(np.float32):
        exact = np.float64(a) * np.float64(b) + np.float64(c)
        # the float64 sum rounds once before float32; the two roundings can
        # differ from one only at a float32 tie (about 2^-29 of draws)
        assert fma_f32(a, b, c) == np.float32(exact)
