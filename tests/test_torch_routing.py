"""Which decoder `make_decoder` builds for every library code, decoder,
schedule and `impl`, held to the reference's order of preference
(`qldpcsim_tpu/decoders/__init__.py::make_decoder` on a TPU, where its
kernels are allowed): the circulant-lifted kernels first, then the general-H
kernel (by itself for MS under L from 512 edge slots on; forced by
impl="gh"), then the row-sequential decoder for one-row layers (forced, or
more than 8 layers), then the incidence decoders (contiguous layers, at most
48), then the edge layout; and every ValueError of the reference."""

import dataclasses

import numpy as np
import pytest
import torch

from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import TannerGraph as RefGraph
from qldpcsim_tpu.decoders import make_decoder as ref_make_decoder

from qldpcsim_torch.codes import CODE_REGISTRY, get_code
from qldpcsim_torch.decoders import (
    DecoderConfig,
    TannerGraph,
    build_layers,
    make_decoder,
)
from qldpcsim_torch.decoders.bf import BFDecoder
from qldpcsim_torch.decoders.cascade import Cascade
from qldpcsim_torch.decoders.common import LayerSchedule
from qldpcsim_torch.decoders.ms import EdgeDecoder
from qldpcsim_torch.decoders.ms_mxu import MxuDecoder
from qldpcsim_torch.decoders.ng import NGDecoder
from qldpcsim_torch.decoders.sequential import SeqDecoder
from qldpcsim_torch.ops.general_h_cuda import GHDecoder
from qldpcsim_torch.ops.ms_qc_cuda import QCDecoder
from qldpcsim_torch.ops.qc import detect_qc
from qldpcsim_torch.ops.seq_qc_cuda import SeqQCDecoder

QC, GH, SEQ, MXU, EDGE, SEQQC = (QCDecoder, GHDecoder, SeqDecoder,
                                 MxuDecoder, EdgeDecoder, SeqQCDecoder)
ERR = ValueError

# (schedule, impl) -> decoder class for MS, or (MS, BP) where they differ.
# A circulant-lifted code (tanner, lp04_*, lp118_*; 9 to 13 layers under L):
QC_CODE = {
    ("F", "auto"): QC, ("L", "auto"): QC, ("S", "auto"): SEQQC,
    ("F", "qc"): QC, ("L", "qc"): QC, ("S", "qc"): SEQQC,
    ("F", "gh"): GH, ("L", "gh"): GH, ("S", "gh"): ERR,
    ("F", "seq"): MXU, ("L", "seq"): MXU, ("S", "seq"): SEQ,
    ("F", "mxu"): MXU, ("L", "mxu"): MXU, ("S", "mxu"): SEQ,
    ("F", "edge"): EDGE, ("L", "edge"): EDGE, ("S", "edge"): EDGE,
}
# bicycle (73 x 146, row weight 18: 1314 edge slots, 73 one-row layers
# under L as under S):
BICYCLE = {
    ("F", "auto"): MXU, ("L", "auto"): (GH, SEQ), ("S", "auto"): SEQ,
    ("F", "qc"): ERR, ("L", "qc"): ERR, ("S", "qc"): ERR,
    ("F", "gh"): GH, ("L", "gh"): GH, ("S", "gh"): ERR,
    ("F", "seq"): MXU, ("L", "seq"): SEQ, ("S", "seq"): SEQ,
    ("F", "mxu"): MXU, ("L", "mxu"): SEQ, ("S", "mxu"): SEQ,
    ("F", "edge"): EDGE, ("L", "edge"): EDGE, ("S", "edge"): EDGE,
}
# steane (3 x 7, 12 edge slots, 3 one-row layers under L as under S), and
# shor's Hx (2 x 9, two one-row layers):
STEANE = {
    ("F", "auto"): MXU, ("L", "auto"): MXU, ("S", "auto"): MXU,
    ("F", "qc"): ERR, ("L", "qc"): ERR, ("S", "qc"): ERR,
    ("F", "gh"): GH, ("L", "gh"): GH, ("S", "gh"): ERR,
    ("F", "seq"): MXU, ("L", "seq"): SEQ, ("S", "seq"): SEQ,
    ("F", "mxu"): MXU, ("L", "mxu"): MXU, ("S", "mxu"): MXU,
    ("F", "edge"): EDGE, ("L", "edge"): EDGE, ("S", "edge"): EDGE,
}
# shor's Hz (6 x 9: two-row layers under L, so impl="seq" finds no serial
# schedule there and the incidence decoder takes it):
SHOR_HZ = {**STEANE, ("L", "seq"): MXU}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_GRAPHS = {}


def _graph(code, side="Hz"):
    if (code, side) not in _GRAPHS:
        H = np.asarray(getattr(get_code(code), side)) % 2
        _GRAPHS[code, side] = (TannerGraph.build(H), {
            s: build_layers(H, s) for s in "FLS"})
    return _GRAPHS[code, side]


def _table(code, side):
    if code == "bicycle":
        return BICYCLE
    if code == "steane" or (code, side) == ("shor", "Hx"):
        return STEANE
    if code == "shor":
        return SHOR_HZ
    return QC_CODE


CASES = [(code, "Hz") for code in sorted(CODE_REGISTRY)] + [("shor", "Hx")]


def test_the_library_is_covered():
    assert {c for c, _ in CASES} == set(CODE_REGISTRY) and len(CASES) == 12
    for code, side in CASES:
        H = _graph(code, side)[0].H
        assert (detect_qc(H) is not None) == (_table(code, side) is QC_CODE)


@pytest.mark.parametrize("impl", ["auto", "qc", "gh", "seq", "mxu", "edge"])
@pytest.mark.parametrize("sched", ["F", "L", "S"])
@pytest.mark.parametrize("code,side", CASES)
def test_make_decoder_routing(code, side, sched, impl):
    graph, layers = _graph(code, side)
    want = _table(code, side)[sched, impl]
    for i, kind in enumerate(("MS", "BP")):
        cfg = DecoderConfig(dec_type=kind, max_iter=8, schedule=sched,
                            impl=impl)
        cls = want[i] if isinstance(want, tuple) else want
        if cls is ERR:
            with pytest.raises(ValueError):
                make_decoder(graph, cfg, layers=layers[sched])
            continue
        dec = make_decoder(graph, cfg, layers=layers[sched])
        assert type(dec) is cls, (kind, type(dec).__name__)
        assert dec.kind == kind and dec.max_iter == 8


PERM = np.random.default_rng(118).permutation(544)


def _permuted_lp118(side):
    """lp118_0 with one column permutation on both sides: the flagship's
    code up to a relabelling of qubits, with no circulant lift left."""
    return (np.asarray(getattr(get_code("lp118_0"), side)) % 2)[:, PERM]


def test_permuted_lp118_is_a_general_h_code():
    Hx, Hz = _permuted_lp118("Hx"), _permuted_lp118("Hz")
    assert not ((Hx.astype(np.int64) @ Hz.T.astype(np.int64)) % 2).any()
    for H, n_layers in ((Hx, 13), (Hz, 11)):
        assert detect_qc(H) is None
        lay = build_layers(H, "L")
        assert lay.n_layers == n_layers
        assert set(lay.sizes.tolist()) == {16, 32}
        dec = make_decoder(TannerGraph.build(H), DecoderConfig(
            dec_type="MS", max_iter=50, schedule="L"))
        assert isinstance(dec, Cascade)
        assert all(isinstance(d, GHDecoder) and d.kind == "MS"
                   for d in dec.decs)
        assert [d.max_iter for d in dec.decs] == [4, 10, 50]
        assert len(dec.decs[0].tabs.runs) == n_layers
        assert not dec.highp_guard
        # two-round plan and no cascade
        two = make_decoder(TannerGraph.build(H), DecoderConfig(
            dec_type="MS", max_iter=50, schedule="L", round1_iters=6))
        assert [d.max_iter for d in two.decs] == [6, 50]
        one = make_decoder(TannerGraph.build(H), DecoderConfig(
            dec_type="MS", max_iter=50, schedule="L", round1_iters=-1))
        assert isinstance(one, GHDecoder) and one.max_iter == 50
        # flooding and BP keep the incidence decoder unless forced
        for kw in (dict(schedule="F"), dict(dec_type="BP", schedule="L")):
            d = make_decoder(TannerGraph.build(H), DecoderConfig(
                max_iter=8, **kw))
            assert isinstance(d, MxuDecoder)


def _random_ldpc(m, n, rw, seed=42):
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.int8)
    for i in range(m):
        H[i, rng.choice(n, rw, replace=False)] = 1
    return H


def test_auto_takes_the_general_h_kernel_from_512_edge_slots():
    """60 x 136 of row weight 8 has 480 edge slots: the incidence decoder;
    64 rows have 512: kernel E (MS under L only)."""
    for m, cls in ((60, MxuDecoder), (64, GHDecoder)):
        H = _random_ldpc(m, 136, 8)
        lay = build_layers(H, "L")
        assert detect_qc(H) is None and 8 < lay.n_layers <= 48
        assert int(lay.sizes.max()) > 1
        dec = make_decoder(TannerGraph.build(H), DecoderConfig(
            dec_type="MS", max_iter=8, schedule="L"))
        assert type(dec) is cls
        forced = make_decoder(TannerGraph.build(H), DecoderConfig(
            dec_type="BP", max_iter=8, schedule="F", impl="gh"))
        assert isinstance(forced, GHDecoder) and forced.kind == "BP"


def _cross_wired(m):
    return LayerSchedule.from_layers([np.arange(0, m, 2),
                                      np.arange(1, m, 2)], m)


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_layers_that_fit_no_fast_path_take_the_edge_layout(kind):
    """Layers that are neither contiguous runs nor single rows: the edge
    decoder by itself; every forced implementation raises. More than 48
    contiguous multi-row layers: the same."""
    H = np.asarray(get_code("steane").Hz) % 2
    graph = TannerGraph.build(H)
    cfg = DecoderConfig(dec_type=kind, max_iter=8, schedule="L")
    assert isinstance(make_decoder(graph, cfg, layers=_cross_wired(3)),
                      EdgeDecoder)
    for impl, match in (("mxu", "mxu path requires"),
                        ("seq", "seq path requires"),
                        ("gh", "gh kernel needs"),
                        ("qc", "qc kernel requires")):
        with pytest.raises(ValueError, match=match):
            make_decoder(graph, dataclasses.replace(cfg, impl=impl),
                         layers=_cross_wired(3))
    H = _random_ldpc(200, 40, 2, seed=1)
    lay = build_layers(H, "L")
    assert lay.n_layers > 48 and int(lay.sizes.max()) > 1
    big = TannerGraph.build(H)
    # 400 edge slots, under 512: min-sum stays off kernel E too
    for impl in ("auto", "edge"):
        assert isinstance(make_decoder(big, dataclasses.replace(
            cfg, impl=impl)), EdgeDecoder)
    with pytest.raises(ValueError, match="mxu path requires"):
        make_decoder(big, dataclasses.replace(cfg, impl="mxu"))


# every ValueError of the reference's dispatch, with its message
RAISES = [
    ("steane", DecoderConfig(schedule="F", impl="qc"), "qc kernel requires"),
    ("bicycle", DecoderConfig(dec_type="BP", schedule="L", impl="qc"),
     "qc kernel requires"),
    ("bicycle", DecoderConfig(schedule="S", impl="qc"),
     "serial qc kernel requires"),
    ("lp04_0", DecoderConfig(schedule="S", impl="gh"),
     "gh kernel supports MS/BP with schedule F/L"),
    ("steane", DecoderConfig(dec_type="BP", schedule="S", impl="gh"),
     "gh kernel supports MS/BP with schedule F/L"),
    ("lp04_0", DecoderConfig(dec_type="XX"), "Unrecognized decoder type"),
    ("lp04_0", DecoderConfig(schedule="X"),
     "Unrecognized decoder scheduling"),
    ("lp04_0", DecoderConfig(dec_type="BF", bf_residual="xor"),
     "bf_residual must be"),
]


@pytest.mark.parametrize("code,cfg,match", RAISES, ids=[
    f"{c}-{k.dec_type}-{k.schedule}-{k.impl}" for c, k, _ in RAISES])
def test_routing_value_errors_equal_the_reference(code, cfg, match):
    graph = _graph(code)[0]
    with pytest.raises(ValueError, match=match):
        make_decoder(graph, cfg)
    ref_cfg = RefConfig(platform="tpu", **{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    with pytest.raises(ValueError, match=match):
        ref_make_decoder(RefGraph.build(graph.H), ref_cfg)


def test_bf_and_ng_take_no_schedule_and_no_cascade():
    graph = _graph("bicycle")[0]
    for kind, cls in (("BF", BFDecoder), ("NG", NGDecoder)):
        dec = make_decoder(graph, DecoderConfig(dec_type=kind, max_iter=99,
                                                schedule="L", impl="gh"))
        assert type(dec) is cls
    assert make_decoder(graph, DecoderConfig(dec_type="BF")).max_iter == 50


def test_an_unknown_impl_takes_the_edge_layout_as_in_the_reference():
    graph = _graph("steane")[0]
    dec = make_decoder(graph, DecoderConfig(max_iter=8, impl="fast"))
    assert isinstance(dec, EdgeDecoder)
