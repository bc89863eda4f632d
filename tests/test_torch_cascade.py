"""The port's straggler cascade is bit-identical to one full-depth decode,
with and without the serial schedule's high-p guard, and equal to the
reference's make_cascade over the Pallas kernel (interpret mode).
make_decoder routes what the port carries and raises for the rest."""

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import TannerGraph as RefGraph
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.decoders.cascade import make_cascade as ref_make_cascade
from qldpcsim_tpu.ops.ms_qc_pallas import make_ms_qc_decoder
from qldpcsim_tpu.ops.qc import detect_qc

from qldpcsim_torch.decoders import (
    DecoderConfig,
    TannerGraph,
    build_layers,
    make_decoder,
)
from qldpcsim_torch.decoders.cascade import (
    Cascade,
    default_stages,
    window_size,
)
from qldpcsim_torch.ops.ms_qc_cuda import QCDecoder
from qldpcsim_torch.ops.seq_qc_cuda import SeqQCDecoder


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


def _same(a, b):
    for name in ("e_hat", "n_iter", "converged", "posterior"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("code,sched,p", [
    ("lp04_0", "L", 0.05), ("lp04_0", "F", 0.12), ("lp118_0", "L", 0.06),
])
@pytest.mark.parametrize("round1", [0, 6])
def test_cascade_equals_full_depth(code, sched, p, round1):
    H = np.asarray(get_code(code).Hz) % 2
    graph = TannerGraph.build(H)
    syn = torch.from_numpy(_syndromes(99, H, 256, p))
    full = make_decoder(graph, DecoderConfig(max_iter=40, schedule=sched,
                                             round1_iters=-1))
    casc = make_decoder(graph, DecoderConfig(max_iter=40, schedule=sched,
                                             round1_iters=round1,
                                             compact_cap_frac=0.25))
    assert isinstance(full, QCDecoder) and isinstance(casc, Cascade)
    r_full, r_casc = full(syn, 0.02), casc(syn, 0.02)
    _same(r_full, r_casc)
    assert (~r_full.converged).any() or p < 0.1
    assert (r_full.n_iter > casc.stages[0][0]).any()


@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("p_err,fires", [(0.12, True), (0.05, False)])
def test_guarded_serial_cascade_equals_full_depth(kind, p_err, fires):
    """Serial schedule, 4 -> 10 -> 30: when more than 2/3 of the batch fails
    the head, the guard skips the 10-iteration stage and decodes the tail
    once at full depth; when few fail, the stages run as usual. Either way
    the results are those of one full-depth decode, bit for bit."""
    H = np.asarray(get_code("lp04_0").Hz) % 2
    graph = TannerGraph.build(H)
    syn = torch.from_numpy(_syndromes(97, H, 96, p_err))
    full = make_decoder(graph, DecoderConfig(
        dec_type=kind, max_iter=30, schedule="S", round1_iters=-1))
    casc = make_decoder(graph, DecoderConfig(
        dec_type=kind, max_iter=30, schedule="S"))
    assert isinstance(full, SeqQCDecoder) and isinstance(casc, Cascade)
    assert casc.stages == [(4, 1.0), (10, 0.125), (30, 1.0 / 32)]
    assert casc.highp_guard and all(d.kind == kind for d in casc.decs)
    p = np.float32(0.05) / np.float32(3.0)
    head = casc.decs[0](syn, p)
    n_failed = int((~head.converged).sum())
    assert n_failed > 0 and (n_failed > (2 * 96) // 3) == fires
    r_full, r_casc = full(syn, p), casc(syn, p)
    _same(r_full, r_casc)
    assert casc.guard_fired == int(fires)
    assert (r_full.n_iter > 4).any()
    if fires:
        assert (~r_full.converged).any()


def test_guard_is_for_the_serial_schedule_only():
    H = np.asarray(get_code("lp04_0").Hz) % 2
    graph = TannerGraph.build(H)
    casc = make_decoder(graph, DecoderConfig(max_iter=30, schedule="L"))
    assert isinstance(casc, Cascade) and not casc.highp_guard
    two = make_decoder(graph, DecoderConfig(max_iter=20, schedule="S"))
    assert isinstance(two, Cascade) and len(two.stages) == 2
    assert not two.highp_guard      # no intermediate stage to skip
    syn = torch.from_numpy(_syndromes(97, H, 96, 0.12))
    casc(syn, 0.02)
    assert casc.guard_fired == 0


def test_cascade_equals_reference_cascade():
    H = np.asarray(get_code("lp118_0").Hz) % 2
    st = detect_qc(H)
    cfg = RefConfig(dec_type="MS", max_iter=50, schedule="L")

    def factory(graph, c, layers=None):
        return make_ms_qc_decoder(st, c, layers=layers, B_blk=32,
                                  interpret=True)

    ref = ref_make_cascade(factory, RefGraph.build(H), cfg,
                           ref_build_layers(H, "L"))
    port = make_decoder(TannerGraph.build(H),
                        DecoderConfig(max_iter=50, schedule="L"))
    assert port.stages == [(4, 1.0), (10, 0.125), (50, 1.0 / 32)]
    syn = _syndromes(3, H, 128, 0.07)
    p = np.float32(0.05) / np.float32(3.0)
    r, o = ref(syn, p), port(torch.from_numpy(syn), p)
    assert (~np.asarray(r.converged)).any()
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    assert np.array_equal(np.asarray(r.posterior), o.posterior.numpy())


def test_stage_plan_and_windows():
    assert default_stages(8) == [(8, 1.0)]
    assert default_stages(20) == [(4, 1.0), (20, 0.125)]
    assert default_stages(50) == [(4, 1.0), (10, 0.125), (50, 1.0 / 32)]
    assert window_size(4096, 0.125) == 512
    assert window_size(4096, 1.0 / 32) == 128
    assert window_size(128, 1.0 / 32) == 64
    assert window_size(40, 0.125) == 40


@pytest.mark.parametrize("code,cfg,err", [
    ("bicycle", DecoderConfig(dec_type="BP", schedule="L", impl="qc"),
     ValueError),
    ("lp04_0", DecoderConfig(dec_type="BF", bf_residual="or"), ValueError),
    ("lp04_0", DecoderConfig(dec_type="NG", schedule="S", impl="gh"), None),
    ("lp04_0", DecoderConfig(dec_type="XX"), ValueError),
    ("lp04_0", DecoderConfig(schedule="X"), ValueError),
    ("lp04_0", DecoderConfig(impl="edge"), None),
    ("bicycle", DecoderConfig(), None),
    ("steane", DecoderConfig(schedule="L"), None),
])
def test_make_decoder_raises_outside_the_slice(code, cfg, err):
    """What `make_decoder` cannot build raises ValueError, as in the
    reference; every decoder, schedule and matrix of the reference builds
    (err None: BF and NG, the edge layout, matrices with no circulant
    lift)."""
    H = np.asarray(get_code(code).Hz) % 2
    if err is None:
        dec = make_decoder(TannerGraph.build(H), cfg)
        out = dec(torch.from_numpy(_syndromes(2, H, 8, 0.02)), 0.01)
        assert out.e_hat.shape == (8, H.shape[1])
        return
    with pytest.raises(err):
        make_decoder(TannerGraph.build(H), cfg)


def test_layer_compat_layers_decode_like_reference():
    """Cross-wired (layer_compat) layers align with the decode matrix's
    block-rows on the library codes, and the decoder built on them equals
    the reference kernel given the same layers."""
    c = get_code("lp04_0")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    ref = make_ms_qc_decoder(
        detect_qc(Hz), RefConfig(dec_type="MS", max_iter=8, schedule="L",
                                 layer_compat=True),
        layers=ref_build_layers(Hz, "L", H_layerize=Hx), B_blk=32,
        interpret=True)
    port = make_decoder(TannerGraph.build(Hz), DecoderConfig(
        max_iter=8, schedule="L"), layers=build_layers(Hz, "L", H_layerize=Hx))
    syn = _syndromes(4, Hz, 40, 0.05)
    r, o = ref(syn, 0.02), port(torch.from_numpy(syn), 0.02)
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    assert np.array_equal(np.asarray(r.posterior), o.posterior.numpy())
