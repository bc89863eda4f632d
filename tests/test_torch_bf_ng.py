"""The port's bit-flipping and naive-greedy decoders (`decoders/bf.py`,
`ng.py`, plain torch) against the JAX package's on the CPU: every quantity
is a small integer, so e_hat, n_iter and converged are equal bit for bit on
every shot (tolerance 0), for both BF residuals, on Shor, Steane, bicycle
and lp04_0."""

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import TannerGraph as RefGraph
from qldpcsim_tpu.decoders.bf import make_bf_decoder as ref_bf
from qldpcsim_tpu.decoders.ng import make_ng_decoder as ref_ng

from qldpcsim_torch.decoders import DecoderConfig, TannerGraph, make_decoder
from qldpcsim_torch.decoders.bf import BFDecoder, make_bf_decoder
from qldpcsim_torch.decoders.ng import NGDecoder, make_ng_decoder


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


def _assert_equal(r, o):
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    assert o.posterior is None and r.posterior is None
    assert o.e_hat.dtype == torch.int8 and o.n_iter.dtype == torch.int32
    assert o.converged.dtype == torch.bool


CODES = [("shor", "Hx", 0.1), ("shor", "Hz", 0.1), ("steane", "Hx", 0.1),
         ("bicycle", "Hx", 0.03), ("bicycle", "Hz", 0.01),
         ("lp04_0", "Hz", 0.03)]


@pytest.mark.parametrize("residual", ["mod2", "bool"])
@pytest.mark.parametrize("code,side,p_err", CODES)
def test_bf_equals_reference(code, side, p_err, residual):
    H = np.asarray(getattr(get_code(code), side)) % 2
    syn = _syndromes(5, H, 64, p_err)
    r = ref_bf(RefGraph.build(H), RefConfig(dec_type="BF",
                                            bf_residual=residual))(syn, None)
    o = make_bf_decoder(TannerGraph.build(H), DecoderConfig(
        dec_type="BF", bf_residual=residual))(torch.from_numpy(syn))
    _assert_equal(r, o)
    conv = o.converged.numpy()
    assert conv.any() and (o.n_iter.numpy()[~conv] == 50).all()
    if residual == "mod2":
        est = (o.e_hat.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
        assert np.array_equal(est[conv], syn[conv])


def test_bf_residuals_differ_where_the_reference_decoder_does():
    """The case of tests/test_decoders.py: a check that meets two flipped
    variables has overlap parity 0 but 'any overlap' 1, so the two
    residuals reach different fixed points; each equals the reference's."""
    H = np.array([[1, 1, 0, 0], [0, 1, 1, 0], [1, 1, 1, 1]], dtype=np.int8)
    syn = np.array([[1, 1, 0]], dtype=np.uint8)
    out = {}
    for residual in ("mod2", "bool"):
        cfg = dict(dec_type="BF", bf_residual=residual, bf_max_iter=2)
        r = ref_bf(RefGraph.build(H), RefConfig(**cfg))(syn, None)
        o = make_bf_decoder(TannerGraph.build(H), DecoderConfig(**cfg))(
            torch.from_numpy(syn))
        _assert_equal(r, o)
        out[residual] = o
    assert not torch.equal(out["mod2"].e_hat, out["bool"].e_hat) or \
        not torch.equal(out["mod2"].converged, out["bool"].converged)
    with pytest.raises(ValueError):
        make_bf_decoder(TannerGraph.build(H), DecoderConfig(
            dec_type="BF", bf_residual="xor"))


@pytest.mark.parametrize("code,side,p_err", CODES)
def test_ng_equals_reference(code, side, p_err):
    H = np.asarray(getattr(get_code(code), side)) % 2
    syn = _syndromes(5, H, 64, p_err)
    syn[0] = 0                           # a zero syndrome: 0 steps
    r = ref_ng(RefGraph.build(H), RefConfig(dec_type="NG"))(syn, None)
    o = make_ng_decoder(TannerGraph.build(H), DecoderConfig(dec_type="NG"))(
        torch.from_numpy(syn))
    _assert_equal(r, o)
    assert int(o.n_iter[0]) == 0 and bool(o.converged[0])
    assert not o.e_hat[0].any()
    conv = o.converged.numpy()
    est = (o.e_hat.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    assert conv.any() and np.array_equal(est[conv], syn[conv])
    # every step flips one bit: an estimate's weight is at most its steps
    assert (o.e_hat.sum(dim=1) <= o.n_iter).all()
    assert int(o.n_iter.max()) <= 2 * H.shape[1]


def test_ng_ties_take_the_first_index_and_dead_ends_stop():
    """Two variables with the same score: the lower index is flipped, as
    np.argmax. A failing check with no variable scores nothing: the shot
    stops after the one step it counted, unconverged."""
    H = np.array([[1, 1, 0], [0, 0, 0]], dtype=np.int8)
    syn = np.array([[1, 0], [0, 1], [1, 1]], dtype=np.int8)
    r = ref_ng(RefGraph.build(H), RefConfig(dec_type="NG"))(syn, None)
    o = make_ng_decoder(TannerGraph.build(H), DecoderConfig(dec_type="NG"))(
        torch.from_numpy(syn))
    _assert_equal(r, o)
    assert o.e_hat.tolist() == [[1, 0, 0], [0, 0, 0], [1, 0, 0]]
    assert o.n_iter.tolist() == [1, 1, 2]
    assert o.converged.tolist() == [True, False, False]


@pytest.mark.parametrize("kind,cls", [("BF", BFDecoder), ("NG", NGDecoder)])
def test_make_decoder_dispatches_bf_and_ng(kind, cls):
    """No schedule, no cascade, no posterior; p is ignored."""
    H = np.asarray(get_code("steane").Hz) % 2
    dec = make_decoder(TannerGraph.build(H), DecoderConfig(
        dec_type=kind.lower(), max_iter=99, schedule="?"))
    assert isinstance(dec, cls)
    syn = torch.from_numpy(_syndromes(7, H, 16, 0.1))
    a, b = dec(syn, 0.01), dec(syn, None)
    assert torch.equal(a.e_hat, b.e_hat) and a.posterior is None
