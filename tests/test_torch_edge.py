"""The port's edge-layout decoders (`decoders/ms.py`, `bp.py`, plain torch)
against the JAX package's (plain XLA) on the CPU: 64 shots per case, numpy
seed 5, 12 iterations, prior 0.05/3.

MS: e_hat, n_iter and converged equal on every shot, and the posterior
equal bit for bit (tolerance 0), when both have run the same number of
iterations. The reference's min-sum loop tests `all(e_lat)` where its BP
loop and its docstring have `all(done)` (`qldpcsim_tpu/decoders/ms.py`,
`cond`), so it never stops early and returns the posterior of iteration
max_iter even when every shot latched long before; the port stops when
every shot has latched. Estimates, iteration counts and counters are the
same either way; only the posterior of a batch whose shots all converged
differs. So each case holds the port against the reference capped at the
number of iterations the port ran.

BP: XLA's tanh, atanh and product reduction round differently from torch's,
so each case asserts the agreement rates it measured (Shor's Hz: see
tests/test_torch_mxu.py).
"""

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import TannerGraph as RefGraph
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.decoders.bp import make_bp_decoder as ref_bp
from qldpcsim_tpu.decoders.ms import make_ms_decoder as ref_ms

from qldpcsim_torch.decoders import (
    DecoderConfig,
    TannerGraph,
    build_layers,
)
from qldpcsim_torch.decoders.bp import make_bp_decoder
from qldpcsim_torch.decoders.common import LayerSchedule
from qldpcsim_torch.decoders.ms import EdgeDecoder, make_ms_decoder

PRIOR = np.float32(0.05) / np.float32(3.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _syndromes(seed, H, n_shots, p):
    rng = np.random.default_rng(seed)
    errs = (rng.random((n_shots, H.shape[1])) < p).astype(np.int64)
    return ((errs @ H.T.astype(np.int64)) % 2).astype(np.int8)


def _H(code, side):
    return np.asarray(getattr(get_code(code), side)) % 2


def _ref(H, kind, sched, max_iter, layers=None):
    return (ref_ms if kind == "MS" else ref_bp)(
        RefGraph.build(H), RefConfig(dec_type=kind, max_iter=max_iter,
                                     schedule=sched),
        layers=layers if layers is not None else ref_build_layers(H, sched))


def _port(H, kind, sched, max_iter, layers=None):
    return (make_ms_decoder if kind == "MS" else make_bp_decoder)(
        TannerGraph.build(H), DecoderConfig(dec_type=kind, max_iter=max_iter,
                                            schedule=sched),
        layers=layers if layers is not None else build_layers(H, sched))


CASES = [
    ("steane", "Hx", "F", 0.1), ("steane", "Hx", "L", 0.1),
    ("shor", "Hz", "F", 0.1), ("shor", "Hz", "L", 0.1),
    ("shor", "Hx", "F", 0.1), ("shor", "Hx", "L", 0.1),
    ("bicycle", "Hx", "F", 0.03), ("bicycle", "Hx", "L", 0.03),
    ("lp04_0", "Hz", "F", 0.03), ("lp04_0", "Hz", "L", 0.03),
    ("lp04_0", "Hz", "S", 0.03),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_ms_edge_equals_reference(case):
    code, side, sched, p_err = case
    H = _H(code, side)
    syn = _syndromes(5, H, 64, p_err)
    o = _port(H, "MS", sched, 12)(torch.from_numpy(syn), PRIOR)
    ran = 12 if not o.converged.all() else int(o.n_iter.max())
    r = _ref(H, "MS", sched, ran)(syn, PRIOR)
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    assert np.array_equal(np.asarray(r.n_iter)[o.converged.numpy()],
                          o.n_iter.numpy()[o.converged.numpy()])
    # by value, tolerance 0
    assert (np.asarray(r.posterior) == o.posterior.numpy()).all()
    full = _ref(H, "MS", sched, 12)(syn, PRIOR)
    assert np.array_equal(np.asarray(full.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(full.n_iter), o.n_iter.numpy())
    assert o.posterior.shape == (64, H.shape[1])
    assert o.e_hat.dtype == torch.int8 and o.n_iter.dtype == torch.int32
    est = (o.e_hat.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    conv = o.converged.numpy()
    assert conv.any() and np.array_equal(est[conv], syn[conv])


# case -> thresholds for converged, n_iter, e_hat agreement and the posterior
# bound over agreeing shots; measured 1, 1, 1 everywhere but Shor Hz (n_iter
# 0.5 under F, 0.609 under L); posterior 1.5e-5 and 1.2e-5 (Steane F, L),
# 2.5e-5 (Shor Hz), 8.1e-7 and 2.1e-6 (Shor Hx), 2.4e-3 and 0.041 (bicycle
# F, L), 0.175 and 8.8e-3 (lp04_0 F, L)
BP_CASES = {
    ("steane", "Hx", "F", 0.1): ((0.98, 0.98, 0.98), 1e-4),
    ("steane", "Hx", "L", 0.1): ((0.98, 0.98, 0.98), 1e-4),
    ("shor", "Hz", "F", 0.1): ((0.98, 0.45, 0.98), 1e-4),
    ("shor", "Hz", "L", 0.1): ((0.98, 0.55, 0.98), 1e-4),
    ("shor", "Hx", "F", 0.1): ((0.98, 0.98, 0.98), 1e-4),
    ("shor", "Hx", "L", 0.1): ((0.98, 0.98, 0.98), 1e-4),
    ("bicycle", "Hx", "F", 0.03): ((0.98, 0.98, 0.98), 1e-2),
    ("bicycle", "Hx", "L", 0.03): ((0.98, 0.98, 0.98), 0.1),
    ("lp04_0", "Hz", "F", 0.03): ((0.98, 0.98, 0.98), 0.4),
    ("lp04_0", "Hz", "L", 0.03): ((0.98, 0.98, 0.98), 0.03),
}


@pytest.mark.parametrize("case", sorted(BP_CASES), ids=lambda c: "-".join(
    map(str, c)))
def test_bp_edge_agrees_with_reference(case):
    (t_conv, t_iter, t_ehat), bound = BP_CASES[case]
    code, side, sched, p_err = case
    H = _H(code, side)
    syn = _syndromes(5, H, 64, p_err)
    r = _ref(H, "BP", sched, 12)(syn, PRIOR)
    o = _port(H, "BP", sched, 12)(torch.from_numpy(syn), PRIOR)
    rc, oc = np.asarray(r.converged), o.converged.numpy()
    ri, oi = np.asarray(r.n_iter), o.n_iter.numpy()
    same_e = (np.asarray(r.e_hat) == o.e_hat.numpy()).all(axis=1)
    assert (rc == oc).mean() >= t_conv
    assert (ri == oi).mean() >= t_iter
    assert same_e.mean() >= t_ehat
    agree = (rc == oc) & (ri == oi) & same_e
    rp, op = np.asarray(r.posterior), o.posterior.numpy()
    rel = np.abs(rp - op) / np.maximum(np.abs(rp), 1.0)
    assert np.isfinite(op).all() and rel[agree].max() <= bound
    est = (o.e_hat.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    assert oc.any() and np.array_equal(est[oc], syn[oc])


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_cross_wired_layers(kind):
    """Layers that are neither contiguous runs nor single rows (the
    reference simulator's cross-wired layers, clipped to the row count) are
    what only the edge layout decodes: the same decisions as the
    reference."""
    Hx, Hz = _H("lp04_0", "Hx"), _H("lp04_0", "Hz")
    m = Hx.shape[0]
    lay = LayerSchedule.from_layers(
        [np.arange(0, m, 2), np.arange(1, m, 2)], m)
    syn = _syndromes(6, Hx, 32, 0.03)
    o = _port(Hx, kind, "L", 8, layers=lay)(torch.from_numpy(syn), PRIOR)
    r = _ref(Hx, kind, "L", 8, layers=lay)(syn, PRIOR)
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert isinstance(_port(Hz, kind, "L", 8), EdgeDecoder)
    with pytest.raises(ValueError):
        EdgeDecoder(TannerGraph.build(Hz), DecoderConfig(), kind="NG")


def test_zero_syndrome_and_default_layers():
    H = _H("steane", "Hz")
    dec = make_ms_decoder(TannerGraph.build(H), DecoderConfig(
        max_iter=5, schedule="L"))
    assert dec.n_layers == build_layers(H, "L").n_layers
    o = dec(torch.zeros((4, 3), dtype=torch.int8), 0.01)
    assert o.converged.all() and (o.n_iter == 1).all() and not o.e_hat.any()
    assert o.posterior.shape == (4, 7)
