"""The port's BP decoder over a circulant-lifted H (plain version on CPU
tensors) against the reference's Pallas BP kernel in interpret mode.

BP cannot be bit-exact here: XLA:CPU evaluates float32 tanh and log with its
own polynomials, torch with others, and they differ in the last ulp on a
large share of inputs (ROADMAP queue 3, "BP transcendentals"). The messages
near the 1 - eps clamp amplify that, so posteriors drift apart while the
decisions mostly agree. Each case asserts the agreement rates it measured
(64 shots, numpy seed 11, p = 0.06, prior 0.05/3), each threshold just under
the measured value, and a bound on the posterior's difference over the
shots where convergence, iteration count and estimate all agree:
max |post - ref| / max(|ref|, 1). For comparison, the JAX package holds
its own BP kernel against its edge decoder at >= 95 % (test_qc_kernel.py).
Zero syndromes and the cascade are exact. Kernel B, kind BP, against this
plain version on the card: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.ops.ms_qc_pallas import make_bp_qc_decoder as ref_bp
from qldpcsim_tpu.ops.qc import detect_qc

from qldpcsim_torch.decoders import (
    DecoderConfig,
    TannerGraph,
    build_layers,
    make_decoder,
)
from qldpcsim_torch.decoders.cascade import Cascade
from qldpcsim_torch.ops import ms_qc_cuda


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


def _both(code, sched, max_iter):
    H = np.asarray(get_code(code).Hz) % 2
    st = detect_qc(H)
    ref = ref_bp(st, RefConfig(dec_type="BP", max_iter=max_iter,
                               schedule=sched),
                 layers=ref_build_layers(H, sched), B_blk=32, interpret=True)
    port = ms_qc_cuda.make_bp_qc_decoder(
        st, DecoderConfig(max_iter=max_iter, schedule=sched),
        layers=build_layers(H, sched))
    return H, ref, port


# (code, schedule, max_iter): measured agreement of converged, n_iter and
# e_hat, and the measured posterior bound -> (thresholds, bound) asserted
CASES = {
    # measured: 1.0, 1.0, 1.0, 0.0559
    ("lp04_0", "F", 8): ((0.98, 0.98, 0.98), 0.06),
    # measured: 1.0, 1.0, 1.0, 0.0533
    ("lp04_0", "F", 30): ((0.98, 0.98, 0.98), 0.06),
    # measured: 1.0, 1.0, 1.0, 0.0118
    ("lp04_0", "L", 8): ((0.98, 0.98, 0.98), 0.015),
    # measured: 1.0, 1.0, 0.984, 0.183
    ("lp04_0", "L", 30): ((0.98, 0.98, 0.98), 0.2),
    # measured: 1.0, 1.0, 1.0, 0.0207
    ("lp118_0", "F", 8): ((0.98, 0.98, 0.98), 0.025),
    # measured: 1.0, 1.0, 0.875, 0.664
    ("lp118_0", "F", 30): ((0.98, 0.98, 0.85), 0.7),
}


@pytest.mark.parametrize("case", sorted(CASES), ids=lambda c: "-".join(
    map(str, c)))
def test_plain_agrees_with_pallas_interpret(case):
    code, sched, max_iter = case
    (t_conv, t_iter, t_ehat), bound = CASES[case]
    H, ref, port = _both(code, sched, max_iter)
    syn = _syndromes(11, H, 64, 0.06)
    p = np.float32(0.05) / np.float32(3.0)
    r, o = ref(syn, p), port(torch.from_numpy(syn), p)
    rc, oc = np.asarray(r.converged), o.converged.numpy()
    ri, oi = np.asarray(r.n_iter), o.n_iter.numpy()
    same_e = (np.asarray(r.e_hat) == o.e_hat.numpy()).all(axis=1)
    assert (rc == oc).mean() >= t_conv
    assert (ri == oi).mean() >= t_iter
    assert same_e.mean() >= t_ehat
    agree = (rc == oc) & (ri == oi) & same_e
    rp, op = np.asarray(r.posterior), o.posterior.numpy()
    rel = np.abs(rp - op) / np.maximum(np.abs(rp), 1.0)
    assert rel[agree].max() <= bound
    # the cases decode: some shots converge, some run out of iterations
    assert rc.any() and not rc.all()


def test_zero_syndrome_is_exact():
    H, ref, port = _both("lp118_0", "F", 5)
    syn = np.zeros((8, H.shape[0]), np.int8)
    r, o = ref(syn, 0.01), port(torch.from_numpy(syn), 0.01)
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    assert np.array_equal(np.asarray(r.posterior), o.posterior.numpy())
    assert o.converged.all() and (o.n_iter == 1).all()


@pytest.mark.parametrize("code,sched", [("lp04_0", "F"), ("lp118_0", "F"),
                                        ("lp04_0", "L")])
def test_cascade_over_bp_equals_full_depth(code, sched):
    """BP is a deterministic function of the syndrome, so the straggler
    cascade (4 -> 10 -> 40 iterations here) gives one full-depth decode's
    results bit for bit, posterior included."""
    H = np.asarray(get_code(code).Hz) % 2
    graph = TannerGraph.build(H)
    syn = torch.from_numpy(_syndromes(98, H, 256, 0.06))
    cfg = DecoderConfig(dec_type="BP", max_iter=40, schedule=sched)
    full = make_decoder(graph, DecoderConfig(
        dec_type="BP", max_iter=40, schedule=sched, round1_iters=-1))
    casc = make_decoder(graph, cfg)
    assert isinstance(casc, Cascade)
    assert casc.stages == [(4, 1.0), (10, 0.125), (40, 1.0 / 32)]
    assert all(d.kind == "BP" for d in casc.decs)
    p = np.float32(0.05) / np.float32(3.0)
    a, b = full(syn, p), casc(syn, p)
    for name in ("e_hat", "n_iter", "converged", "posterior"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.n_iter > 10).any() and (~a.converged).any()


def test_bp_clamp_is_float32_of_one_minus_eps():
    st = detect_qc(np.asarray(get_code("lp04_0").Hz) % 2)
    dec = ms_qc_cuda.make_bp_qc_decoder(st, DecoderConfig(eps=1e-6))
    assert dec.kind == "BP"
    assert dec.clamp == float(np.float32(1.0 - 1e-6))
    assert ms_qc_cuda.make_qc_decoder(st, DecoderConfig(
        dec_type="bp")).kind == "BP"
