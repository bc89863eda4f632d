"""The port's row-sequential decoder (`decoders/sequential.py`, plain torch)
against the JAX package's `make_seq_decoder` (plain XLA) on the CPU, and the
routing of `make_decoder(schedule="S")`.

What was found (64 shots per case, numpy seed 5, 12 iterations, prior
0.05/3). MS: e_hat, n_iter and converged equal on every shot of every case;
the posterior is equal bit for bit on Steane and Shor (tolerance 0) and
within 1.94e-4 of max(|ref|, 1) on lp04_0, where the two differ by single
ulps from the third iteration on in a few heavy shots (XLA:CPU contracts
some multiply-add of its fused row update that torch keeps apart; forming
`new - old` as one fma, which is what makes the Pallas serial kernel match,
makes this path differ more, so the port keeps the separate operations).
BP: XLA's tanh, atanh and product reduction round differently from torch's,
so each case asserts the agreement rates it measured. On Shor's Hz (rows of
weight 2) a BP message is +-L_ch up to rounding, the posterior of a flipped
bit is L_ch - L_ch up to rounding, and its sign, hence the row at which a
shot latches, is a coin toss between two libraries: n_iter agrees on 61 %
of shots there while e_hat and converged agree on all.
"""

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import TannerGraph as RefGraph
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.decoders.sequential import make_seq_decoder as ref_make
from qldpcsim_tpu.decoders.sequential import supports as ref_supports

from qldpcsim_torch.decoders import (
    DecoderConfig,
    TannerGraph,
    build_layers,
    make_decoder,
)
from qldpcsim_torch.decoders.cascade import Cascade
from qldpcsim_torch.decoders.common import LayerSchedule
from qldpcsim_torch.decoders.ms_mxu import MxuDecoder
from qldpcsim_torch.decoders.sequential import (
    SeqDecoder,
    make_bp_seq_decoder,
    make_ms_seq_decoder,
    make_seq_decoder,
    supports,
)
from qldpcsim_torch.ops.seq_qc_cuda import SeqQCDecoder

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


def _run_both(code, side, kind, p_err):
    H = _H(code, side)
    syn = _syndromes(5, H, 64, p_err)
    ref = ref_make(RefGraph.build(H), RefConfig(dec_type=kind, max_iter=12,
                                                schedule="S"),
                   layers=ref_build_layers(H, "S"), kind=kind)
    port = make_seq_decoder(TannerGraph.build(H), DecoderConfig(
        dec_type=kind, max_iter=12, schedule="S"),
        layers=build_layers(H, "S"), kind=kind)
    return H, syn, ref(syn, PRIOR), port(torch.from_numpy(syn), PRIOR)


# (code, side, bit-flip rate) -> bound on |post - ref| / max(|ref|, 1);
# measured: 0 on Steane and Shor, 1.94e-4 (Hx) and 1.35e-6 (Hz) on lp04_0
MS_CASES = {
    ("steane", "Hx", 0.1): 0.0, ("steane", "Hz", 0.1): 0.0,
    ("shor", "Hx", 0.1): 0.0, ("shor", "Hz", 0.1): 0.0,
    ("lp04_0", "Hx", 0.03): 3e-4, ("lp04_0", "Hz", 0.03): 3e-6,
}


@pytest.mark.parametrize("case", sorted(MS_CASES), ids=lambda c: "-".join(
    map(str, c)))
def test_ms_equals_reference_sequential(case):
    H, syn, r, o = _run_both(case[0], case[1], "MS", case[2])
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    rp, op = np.asarray(r.posterior), o.posterior.numpy()
    rel = np.abs(rp - op) / np.maximum(np.abs(rp), 1.0)
    assert rel.max() <= MS_CASES[case]
    assert o.posterior.shape == (64, H.shape[1])
    assert o.converged.any() and len(np.unique(o.n_iter.numpy())) >= 2
    est = (o.e_hat.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    conv = o.converged.numpy()
    assert np.array_equal(est[conv], syn[conv])


# (code, side, bit-flip rate) -> thresholds for converged, n_iter, e_hat
# agreement; measured 1.0, 1.0, 1.0 everywhere but Shor Hz (1.0, 0.609, 1.0)
BP_CASES = {
    ("steane", "Hx", 0.1): (0.98, 0.98, 0.98),
    ("shor", "Hx", 0.1): (0.98, 0.98, 0.98),
    ("shor", "Hz", 0.1): (0.98, 0.55, 0.98),
    ("lp04_0", "Hx", 0.03): (0.98, 0.98, 0.98),
    ("lp04_0", "Hz", 0.03): (0.98, 0.98, 0.98),
}


@pytest.mark.parametrize("case", sorted(BP_CASES), ids=lambda c: "-".join(
    map(str, c)))
def test_bp_agrees_with_reference_sequential(case):
    t_conv, t_iter, t_ehat = BP_CASES[case]
    H, syn, r, o = _run_both(case[0], case[1], "BP", case[2])
    same_e = (np.asarray(r.e_hat) == o.e_hat.numpy()).all(axis=1)
    assert (np.asarray(r.converged) == o.converged.numpy()).mean() >= t_conv
    assert (np.asarray(r.n_iter) == o.n_iter.numpy()).mean() >= t_iter
    assert same_e.mean() >= t_ehat
    assert np.isfinite(o.posterior.numpy()).all()
    est = (o.e_hat.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    conv = o.converged.numpy()
    assert conv.any() and np.array_equal(est[conv], syn[conv])


def test_zero_syndrome_and_row_order():
    """A zero syndrome latches after the first row (n_iter == 1); rows are
    taken in the order of the layers, natural or not."""
    H = _H("steane", "Hz")
    graph = TannerGraph.build(H)
    cfg = DecoderConfig(max_iter=5, schedule="S")
    dec = make_ms_seq_decoder(graph, cfg)
    assert dec.order == [0, 1, 2] and dec.kind == "MS"
    o = dec(torch.zeros((4, 3), dtype=torch.int8), 0.01)
    assert o.converged.all() and (o.n_iter == 1).all() and not o.e_hat.any()
    from qldpcsim_torch.decoders.common import LayerSchedule
    rev = LayerSchedule.from_layers([np.array([r]) for r in (2, 1, 0)], 3)
    assert make_bp_seq_decoder(graph, cfg, layers=rev).order == [2, 1, 0]
    assert supports(rev) == ref_supports(rev) == True  # noqa: E712
    lay = build_layers(_H("lp04_0", "Hz"), "L")
    assert supports(lay) == ref_supports(lay) == False  # noqa: E712
    assert not supports(None)
    with pytest.raises(ValueError):
        make_seq_decoder(TannerGraph.build(_H("lp04_0", "Hz")), cfg,
                         layers=lay)
    with pytest.raises(ValueError):
        make_seq_decoder(graph, cfg, kind="BF")


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_serial_routing(kind):
    """schedule="S": a circulant-lifted H in natural one-row order goes to
    the serial QC decoder (kernel D), other matrices with one-row layers to
    the row-sequential decoder or, with at most 8 of them, to the incidence
    decoder; deep budgets get the guarded cascade."""
    qc_graph = TannerGraph.build(_H("lp04_0", "Hz"))
    small = make_decoder(qc_graph, DecoderConfig(dec_type=kind, max_iter=8,
                                                 schedule="S"))
    assert isinstance(small, SeqQCDecoder) and small.kind == kind
    deep = make_decoder(qc_graph, DecoderConfig(dec_type=kind, max_iter=30,
                                                schedule="S"))
    assert isinstance(deep, Cascade) and deep.highp_guard
    assert all(isinstance(d, SeqQCDecoder) and d.kind == kind
               for d in deep.decs)
    assert [d.max_iter for d in deep.decs] == [4, 10, 30]
    forced = make_decoder(qc_graph, DecoderConfig(
        dec_type=kind, max_iter=8, schedule="S", impl="qc"))
    assert isinstance(forced, SeqQCDecoder)
    # a matrix with no circulant lift: the row-sequential decoder from 9
    # one-row layers on, the incidence decoder below that (the reference's
    # rule), and the row-sequential decoder when it is asked for
    dec = make_decoder(TannerGraph.build(_H("bicycle", "Hz")), DecoderConfig(
        dec_type=kind, max_iter=8, schedule="S"))
    assert isinstance(dec, SeqDecoder) and dec.kind == kind
    for code in ("steane", "shor"):
        graph = TannerGraph.build(_H(code, "Hz"))
        dec = make_decoder(graph, DecoderConfig(
            dec_type=kind, max_iter=8, schedule="S"))
        assert isinstance(dec, MxuDecoder) and dec.kind == kind
        dec = make_decoder(graph, DecoderConfig(
            dec_type=kind, max_iter=8, schedule="S", impl="seq"))
        assert isinstance(dec, SeqDecoder) and dec.kind == kind
    # impl="seq" forces the row-sequential path on a QC matrix too
    seq = make_decoder(qc_graph, DecoderConfig(dec_type=kind, max_iter=8,
                                               schedule="S", impl="seq"))
    assert isinstance(seq, SeqDecoder)
    # cross-wired (layer_compat) serial layers of another row count are not
    # the natural order: row-sequential
    Hx = _H("shor", "Hx")
    lay = build_layers(Hx, "S", H_layerize=_H("shor", "Hz"))
    dec = make_decoder(TannerGraph.build(Hx), DecoderConfig(
        dec_type=kind, max_iter=8, schedule="S", impl="seq"), layers=lay)
    assert isinstance(dec, SeqDecoder) and dec.order == [0, 1]


def _two_interleaved_layers(m):
    """Layers that are neither contiguous runs nor single rows."""
    return LayerSchedule.from_layers([np.arange(0, m, 2),
                                      np.arange(1, m, 2)], m)


@pytest.mark.parametrize("code,cfg,layers,err,match", [
    ("steane", DecoderConfig(schedule="S", impl="qc"), None, ValueError,
     "serial qc kernel requires"),
    ("lp04_0", DecoderConfig(schedule="F", impl="seq"),
     _two_interleaved_layers, ValueError, "seq path requires"),
    ("lp04_0", DecoderConfig(schedule="L", impl="seq"),
     _two_interleaved_layers, ValueError, "seq path requires"),
    ("steane", DecoderConfig(schedule="L", impl="qc"), None, ValueError,
     "qc kernel requires"),
    ("steane", DecoderConfig(schedule="F", impl="mxu"),
     _two_interleaved_layers, ValueError, "mxu path requires"),
    ("lp04_0", DecoderConfig(schedule="S", impl="gh"), None, ValueError,
     "gh kernel supports"),
    ("lp04_0", DecoderConfig(dec_type="BF", schedule="S",
                             bf_residual="any"), None, ValueError,
     "bf_residual must be"),
])
def test_routing_raises(code, cfg, layers, err, match):
    """`impl="seq"` and `impl="mxu"` raise only where neither the
    row-sequential nor the incidence decoder fits the layers (as in the
    reference, `impl="seq"` under F or L with contiguous layers takes the
    incidence decoder: tests/test_torch_routing.py)."""
    H = _H(code, "Hz")
    with pytest.raises(err, match=match):
        make_decoder(TannerGraph.build(H), cfg,
                     layers=layers(H.shape[0]) if layers else None)


def test_serial_qc_and_sequential_agree_on_decisions():
    """The two serial decoders of the port run the same schedule over
    lp04_0: equal convergence, iteration counts and estimates (their
    posteriors differ in the last bits: one fma against two operations)."""
    H = _H("lp04_0", "Hz")
    graph = TannerGraph.build(H)
    syn = torch.from_numpy(_syndromes(6, H, 48, 0.03))
    cfg = DecoderConfig(max_iter=10, schedule="S")
    a = make_decoder(graph, cfg)(syn, PRIOR)
    b = make_decoder(graph, DecoderConfig(max_iter=10, schedule="S",
                                          impl="seq"))(syn, PRIOR)
    assert torch.equal(a.converged, b.converged)
    assert torch.equal(a.n_iter, b.n_iter)
    assert torch.equal(a.e_hat, b.e_hat)
    assert torch.allclose(a.posterior, b.posterior, rtol=1e-3, atol=1e-3)
