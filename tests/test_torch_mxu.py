"""The port's incidence-product decoders (`decoders/ms_mxu.py`, `bp_mxu.py`,
plain torch) against the JAX package's (plain XLA) on the CPU: 64 shots per
case, numpy seed 5, 12 iterations, prior 0.05/3.

MS: e_hat, n_iter and converged equal on every shot of every case. The
posterior is equal bit for bit (tolerance 0) wherever a variable receives
one delta per layer (every layered case, and flooding on Steane and Shor,
whose deltas are sums of equal magnitudes); under flooding on bicycle and
lp04_0 a variable's 3 to 18 deltas are summed by two different matrix
products, and each case asserts the bound it measured.

BP: XLA's tanh, atanh and product reduction round differently from torch's,
so each case asserts the agreement rates it measured. On Shor's Hz (rows of
weight 2) the posterior of a flipped bit is L_ch - L_ch up to rounding, and
its sign, hence the layer at which a shot latches, is a coin toss between
two libraries: n_iter agrees on 50 to 61 % of shots there, e_hat and
converged on all.
"""

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import TannerGraph as RefGraph
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.decoders.bp_mxu import make_bp_mxu_decoder as ref_bp
from qldpcsim_tpu.decoders.ms_mxu import make_ms_mxu_decoder as ref_ms
from qldpcsim_tpu.decoders.ms_mxu import supports as ref_supports

from qldpcsim_torch.decoders import (
    DecoderConfig,
    TannerGraph,
    build_layers,
)
from qldpcsim_torch.decoders.bp_mxu import make_bp_mxu_decoder
from qldpcsim_torch.decoders.common import LayerSchedule
from qldpcsim_torch.decoders.ms_mxu import (
    MxuDecoder,
    make_ms_mxu_decoder,
    supports,
)

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


def _run_both(code, side, sched, kind, p_err):
    H = np.asarray(getattr(get_code(code), side)) % 2
    syn = _syndromes(5, H, 64, p_err)
    ref = (ref_ms if kind == "MS" else ref_bp)(
        RefGraph.build(H), RefConfig(dec_type=kind, max_iter=12,
                                     schedule=sched),
        layers=ref_build_layers(H, sched))
    port = (make_ms_mxu_decoder if kind == "MS" else make_bp_mxu_decoder)(
        TannerGraph.build(H), DecoderConfig(dec_type=kind, max_iter=12,
                                            schedule=sched),
        layers=build_layers(H, sched))
    assert port.kind == kind
    return H, syn, ref(syn, PRIOR), port(torch.from_numpy(syn), PRIOR)


# (code, side, schedule, bit-flip rate) -> bound on |post - ref| /
# max(|ref|, 1); measured 0 everywhere but bicycle F (4.61e-3: a shot that
# never converges, whose messages grow) and lp04_0 F (4.41e-6)
MS_CASES = {
    ("steane", "Hx", "F", 0.1): 0.0, ("steane", "Hx", "L", 0.1): 0.0,
    ("shor", "Hz", "F", 0.1): 0.0, ("shor", "Hz", "L", 0.1): 0.0,
    ("shor", "Hx", "F", 0.1): 0.0, ("shor", "Hx", "L", 0.1): 0.0,
    ("bicycle", "Hx", "F", 0.03): 1e-2,
    ("lp04_0", "Hz", "F", 0.03): 1e-5, ("lp04_0", "Hz", "L", 0.03): 0.0,
}


@pytest.mark.parametrize("case", sorted(MS_CASES), ids=lambda c: "-".join(
    map(str, c)))
def test_ms_mxu_equals_reference(case):
    H, syn, r, o = _run_both(case[0], case[1], case[2], "MS", case[3])
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    rp, op = np.asarray(r.posterior), o.posterior.numpy()
    rel = np.abs(rp - op) / np.maximum(np.abs(rp), 1.0)
    assert rel.max() <= MS_CASES[case]
    assert o.posterior.shape == (64, H.shape[1])
    assert o.e_hat.dtype == torch.int8 and o.n_iter.dtype == torch.int32
    est = (o.e_hat.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    conv = o.converged.numpy()
    assert conv.any() and np.array_equal(est[conv], syn[conv])


# (code, side, schedule, bit-flip rate) -> thresholds for converged, n_iter,
# e_hat agreement and the posterior bound over agreeing shots; measured 1, 1,
# 1 everywhere but Shor Hz (n_iter 0.5 under F, 0.609 under L); posterior
# 1.5e-5 and 1.2e-5 (Steane F, L), 2.5e-5 (Shor Hz), 3.8e-6 and 2.1e-6 (Shor
# Hx), 2.5e-3 (bicycle), 0.048 and 0.242 (lp04_0 F, L)
BP_CASES = {
    ("steane", "Hx", "F", 0.1): ((0.98, 0.98, 0.98), 1e-4),
    ("steane", "Hx", "L", 0.1): ((0.98, 0.98, 0.98), 1e-4),
    ("shor", "Hz", "F", 0.1): ((0.98, 0.45, 0.98), 1e-4),
    ("shor", "Hz", "L", 0.1): ((0.98, 0.55, 0.98), 1e-4),
    ("shor", "Hx", "F", 0.1): ((0.98, 0.98, 0.98), 1e-4),
    ("shor", "Hx", "L", 0.1): ((0.98, 0.98, 0.98), 1e-4),
    ("bicycle", "Hx", "F", 0.03): ((0.98, 0.98, 0.98), 1e-2),
    ("lp04_0", "Hz", "F", 0.03): ((0.98, 0.98, 0.98), 0.1),
    ("lp04_0", "Hz", "L", 0.03): ((0.98, 0.98, 0.98), 0.5),
}


@pytest.mark.parametrize("case", sorted(BP_CASES), ids=lambda c: "-".join(
    map(str, c)))
def test_bp_mxu_agrees_with_reference(case):
    (t_conv, t_iter, t_ehat), bound = BP_CASES[case]
    H, syn, r, o = _run_both(case[0], case[1], case[2], "BP", case[3])
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


def test_latched_estimate_and_early_exit():
    """A shot's estimate and n_iter are those of the layer at which it first
    reproduced its syndrome, while its posterior keeps moving until the
    whole batch is done (nothing is frozen); a batch of zero syndromes stops
    after one iteration."""
    H = np.asarray(get_code("lp04_0").Hz) % 2
    graph = TannerGraph.build(H)
    dec = make_ms_mxu_decoder(graph, DecoderConfig(max_iter=12, schedule="L"))
    zero = torch.zeros((4, H.shape[0]), dtype=torch.int8)
    o = dec(zero, 0.01)
    assert o.converged.all() and (o.n_iter == 1).all() and not o.e_hat.any()
    syn = torch.from_numpy(_syndromes(5, H, 64, 0.03))
    whole = dec(syn, PRIOR)
    conv = whole.converged.numpy()
    assert conv.any() and not conv.all()
    alone = dec(syn[conv], PRIOR)        # the converged shots on their own
    assert torch.equal(alone.e_hat, whole.e_hat[conv])
    assert torch.equal(alone.n_iter, whole.n_iter[conv])
    assert not torch.equal(alone.posterior, whole.posterior[conv])


def test_supports_and_layers():
    H = np.asarray(get_code("bicycle").Hx) % 2
    graph, m = TannerGraph.build(H), H.shape[0]
    cases = {
        "none": None,
        "flooding": build_layers(H, "F"),
        "layered, 73 one-row layers": build_layers(H, "L"),
        "cross-wired": LayerSchedule.from_layers(
            [np.array([0, 2]), np.array([1])] + [np.arange(3, m)], m),
        "48 layers": LayerSchedule.from_layers(
            [np.array([r]) for r in range(47)] + [np.arange(47, m)], m),
        "49 layers": LayerSchedule.from_layers(
            [np.array([r]) for r in range(48)] + [np.arange(48, m)], m),
    }
    for name, layers in cases.items():
        if name != "cross-wired":   # the reference's comparison of a
            # 2-row layer with a 3-row range raises inside numpy
            assert supports(graph, layers) == ref_supports(
                RefGraph.build(H), layers), name
    assert supports(graph, None) and supports(graph, cases["48 layers"])
    assert not supports(graph, cases["49 layers"])
    assert not supports(graph, cases["cross-wired"])
    with pytest.raises(ValueError):
        make_ms_mxu_decoder(graph, DecoderConfig(schedule="L"),
                            layers=cases["cross-wired"])
    with pytest.raises(ValueError):
        MxuDecoder(graph, DecoderConfig(), kind="BF")
    dec = make_bp_mxu_decoder(graph, DecoderConfig(schedule="L"),
                              layers=cases["48 layers"])
    assert len(dec.ranges) == 48 and dec.ranges[-1] == (47, m)
