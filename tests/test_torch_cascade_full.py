"""The straggler cascade's two paths on the CPU. Where every stage decoder
is a `QCDecoder` on kernel B or a `SeqQCDecoder` on kernel D, the cascade
on the card is one full-depth call of its last stage decoder
(`Cascade.forward_full`); everywhere else, and for the plain versions, it
runs its stages (`forward_stages`). Here `forward_full` runs through the
plain versions: its results equal the stages' (the serial schedule's with
the high-p guard firing) and one full-depth decode's bit for bit, with no
host sync. Syndromes that say they lie on the card (`_OnCard`) show which
path `forward` takes there."""

import numpy as np
import pytest
import torch

from qldpcsim_torch.codes import get_code
from qldpcsim_torch.decoders import (
    DecoderConfig,
    TannerGraph,
    build_layers,
    make_decoder,
)
from qldpcsim_torch.decoders.cascade import Cascade, make_cascade
from qldpcsim_torch.engine.montecarlo import SimConfig, simulate_p
from qldpcsim_torch.ops.ms_qc_cuda import QCDecoder, make_qc_decoder
from qldpcsim_torch.ops.qc import detect_qc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# lp118_0 under the benchmark's two decoders: MS-L-50 and BP-F-99, both
# planned (4, 1), (10, 1/8), (cap, 1/32)
KINDS = {"MS-L-50": ("MS", "L", 50), "BP-F-99": ("BP", "F", 99)}
# the chunks: the error rate of the syndromes, and how many lanes fail the
# 4-iteration head ("none", "some", "all")
CHUNKS = {"none": (0.002, "none"), "some": (0.06, "some"),
          "all": (0.3, "all")}
PRIOR = np.float32(0.05) / np.float32(3.0)


def _H(code="lp118_0"):
    return np.asarray(get_code(code).Hz) % 2


def _syndromes(seed, H, n_shots, p):
    rng = np.random.default_rng(seed)
    errs = (rng.random((n_shots, H.shape[1])) < p).astype(np.int64)
    return torch.from_numpy(
        ((errs @ H.T.astype(np.int64)) % 2).astype(np.int8))


def _decoders(kind_name, H, **qc):
    """A cascade of kernel-B decoders and the full-depth decoder; `qc`
    goes to `make_qc_decoder` (the state's dtype, the writeback)."""
    kind, sched, it = KINDS[kind_name]
    graph, layers = TannerGraph.build(H), build_layers(H, sched)
    cfg = DecoderConfig(dec_type=kind, max_iter=it, schedule=sched)
    st = detect_qc(H)

    def factory(g, c, layers=None):
        return make_qc_decoder(st, c, layers=layers, **qc)

    return make_cascade(factory, graph, cfg, layers), factory(
        graph, cfg, layers=layers)


def _same(a, b):
    for name in ("e_hat", "n_iter", "converged", "posterior"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


class _OnCard(torch.Tensor):
    """CPU syndromes that say they lie on the card, so that
    `Cascade.forward` routes them as it would a CUDA tensor."""

    @property
    def is_cuda(self):
        return True


def _forward_on_card(casc, syn, p=PRIOR):
    """`casc.forward` on syndromes routed as the card's; the path it picks
    then runs on the plain CPU tensor."""
    for name in ("forward_full", "forward_stages"):
        real = getattr(casc, name)
        setattr(casc, name,
                lambda s, q, real=real: real(s.as_subclass(torch.Tensor), q))
    try:
        return casc(syn.as_subclass(_OnCard), p)
    finally:
        del casc.forward_full, casc.forward_stages


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("kind_name", list(KINDS))
def test_full_depth_equals_stages_and_full_decode(kind_name, chunk):
    """Both paths on the same chunk: results bit for bit those of one
    full-depth decode; the full-depth path syncs never and counts the batch
    as the head's lanes, the stages sync once per stage reached."""
    H = _H()
    p_err, fails = CHUNKS[chunk]
    syn = _syndromes(11, H, 48, p_err)
    casc, full = _decoders(kind_name, H)
    host, _ = _decoders(kind_name, H)
    assert isinstance(casc, Cascade) and casc.full_depth
    assert all(isinstance(d, QCDecoder) for d in casc.decs)
    r_casc = casc.forward_full(syn, PRIOR)
    r_host = host.forward_stages(syn, PRIOR)
    r_full = full(syn, PRIOR)
    _same(r_casc, r_full)
    _same(r_host, r_full)
    head_fail = int((r_full.n_iter > casc.stages[0][0]).sum())
    assert {"none": head_fail == 0, "some": 0 < head_fail < 48,
            "all": head_fail == 48}[fails]
    assert casc.stage_lanes == [48, 0, 0] and casc.syncs == 0
    assert host.stage_lanes[:2] == [48, head_fail]
    assert host.syncs == (1 if head_fail == 0 else 2)


@pytest.mark.parametrize("kind_name", list(KINDS))
def test_partial_chunk(kind_name):
    """A full chunk of 64 and a partial one of 40 whose tail is padding
    (a chunk with n_valid < B): the results stay those of the full-depth
    decode, and the lanes add up over both calls."""
    H = _H()
    casc, full = _decoders(kind_name, H)
    host, _ = _decoders(kind_name, H)
    syn = _syndromes(5, H, 64, 0.06)
    part = syn[:40].clone()
    part[30:] = 0        # the tail of a partial chunk: nothing to decode
    for s in (syn, part):
        r = casc.forward_full(s, PRIOR)
        _same(r, full(s, PRIOR))
        _same(host.forward_stages(s, PRIOR), r)
    assert casc.stage_lanes == [104, 0, 0] and casc.syncs == 0
    assert host.stage_lanes[0] == 104


@pytest.mark.parametrize("qc", [dict(dtype=torch.bfloat16), dict(vec=True)],
                         ids=["bf16", "vec"])
def test_full_depth_equals_stages_for_kernel_b_variants(qc):
    """The bf16 state and the stacked-update writeback (MS-L-50): the
    full-depth path equals the stages bit for bit."""
    H = _H()
    casc, full = _decoders("MS-L-50", H, **qc)
    host, _ = _decoders("MS-L-50", H, **qc)
    assert casc.full_depth and casc.decs[0].vec == qc.get("vec", False)
    syn = _syndromes(9, H, 48, 0.06)
    r = casc.forward_full(syn, PRIOR)
    _same(r, full(syn, PRIOR))
    _same(r, host.forward_stages(syn, PRIOR))
    assert host.syncs == 2


def test_the_plain_version_runs_the_stages():
    """On CPU tensors `forward` takes the stages: kernel B's plain version
    runs its batch in lockstep, so the cascade still pays there."""
    H = _H("lp04_0")
    casc = make_decoder(TannerGraph.build(H), DecoderConfig(
        max_iter=30, schedule="L"), layers=build_layers(H, "L"))
    assert casc.full_depth
    syn = _syndromes(3, H, 32, 0.08)
    r = casc(syn, PRIOR)
    assert casc.syncs >= 1 and casc.stage_lanes[1] > 0
    _same(r, casc.forward_full(syn, PRIOR))


def test_stage_plan_and_head_are_kept():
    """Kernel B's cascade keeps the plan and the stage decoders (the head
    first, whose type, state and beta name the side's decoder); only the
    last one runs on the full-depth path."""
    H = _H()
    casc, _ = _decoders("MS-L-50", H)
    assert casc.stages == [(4, 1.0), (10, 0.125), (50, 1.0 / 32)]
    assert [d.max_iter for d in casc.decs] == [4, 10, 50]
    assert casc.decs[0].beta == casc.decs[-1].beta


def test_stage_lanes_is_assignable():
    H = _H("lp04_0")
    casc = make_decoder(TannerGraph.build(H), DecoderConfig(
        max_iter=30, schedule="L"), layers=build_layers(H, "L"))
    syn = _syndromes(3, H, 32, 0.08)
    casc.forward_full(syn, PRIOR)
    assert casc.stage_lanes == [32, 0, 0]
    casc.stage_lanes = [0] * len(casc.stages)
    casc.forward_full(syn, PRIOR)
    assert casc.stage_lanes == [32, 0, 0]


def _serial(H, kind="MS"):
    return make_decoder(TannerGraph.build(H), DecoderConfig(
        dec_type=kind, max_iter=30, schedule="S"), layers=build_layers(H, "S"))


# the serial schedule at p 0.10 (the Tanner cell's point): shots a chunk
SERIAL_SHOTS = {"lp04_0": 48, "tanner": 16}


@pytest.mark.parametrize("chunk", ["full", "partial"])
@pytest.mark.parametrize("code", list(SERIAL_SHOTS))
def test_serial_full_depth_equals_guarded_stages(code, chunk):
    """A serial-schedule MS cascade (kernel D's plain version, 4 -> 10 ->
    30) at p 0.10: the full-depth path gives the e_hat, n_iter, converged
    and posterior of the stages bit for bit, where the high-p guard fires
    and sends the tail straight to full depth; also on a partial chunk
    whose last quarter is padding. The full-depth path syncs never, decodes
    no window and leaves the guard alone."""
    H = _H(code)
    n = SERIAL_SHOTS[code]
    syn = _syndromes(13, H, n, 0.10)
    if chunk == "partial":
        n = 3 * n // 4
        syn = syn[:n].clone()
        syn[n - n // 4:] = 0
    casc, host = _serial(H), _serial(H)
    assert casc.full_depth and casc.highp_guard
    r = casc.forward_full(syn, PRIOR)
    _same(r, host.forward_stages(syn, PRIOR))
    head_fail = int((r.n_iter > casc.stages[0][0]).sum())
    assert head_fail > (2 * n) // 3
    assert host.guard_fired == 1 and host.syncs == 1
    assert host.stage_lanes == [n, 0, head_fail]
    assert casc.full_calls == 1 and casc.stage_lanes == [n, 0, 0]
    assert casc.syncs == casc.windows == casc.guard_fired == 0


def _general(H):
    perm = np.random.default_rng(4).permutation(H.shape[1])
    Hp = H[:, perm]
    return make_decoder(TannerGraph.build(Hp), DecoderConfig(
        max_iter=30, schedule="L", impl="gh"),
        layers=build_layers(Hp, "L")), Hp


def _stacked(H):
    st = detect_qc(H)

    def factory(graph, cfg, layers=None):
        return make_qc_decoder(st, cfg, layers=layers, stacked=True)

    return make_cascade(factory, TannerGraph.build(H), DecoderConfig(
        max_iter=30, schedule="F"), build_layers(H, "F"))


@pytest.mark.parametrize("kernel", ["E", "F"])
def test_other_kernels_keep_the_stages(kernel):
    """Kernels E and F keep the stages on the card too, a host sync per
    stage reached, though each shot leaves their launch at its convergence
    as in kernels B and D: no benchmark cell measures them yet."""
    H = _H("lp04_0")
    if kernel == "E":
        casc, H = _general(H)
    else:
        casc = _stacked(H)
        assert all(d.stacked for d in casc.decs)
    assert isinstance(casc, Cascade) and not casc.full_depth
    assert not casc.highp_guard
    syn = _syndromes(6, H, 48, 0.06)
    r = _forward_on_card(casc, syn)
    assert casc.syncs >= 1 and casc.stage_lanes[0] == 48
    assert casc.full_calls == 0
    _same(r, casc.forward_stages(syn, PRIOR))


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_kernel_d_takes_the_full_depth_path(kind):
    """Kernel D's cascade (serial schedule, with the high-p guard) takes the
    one full-depth launch on the card: `full_calls` counts it and no host
    sync is made; on CPU tensors it runs the stages, with the same
    results."""
    H = _H("lp04_0")
    casc = _serial(H, kind)
    assert isinstance(casc, Cascade) and casc.full_depth
    assert casc.highp_guard and all(d.kind == kind for d in casc.decs)
    syn = _syndromes(6, H, 48, 0.06)
    r_cpu = casc(syn, PRIOR)
    assert casc.syncs >= 1 and casc.full_calls == 0
    syncs, lanes = casc.syncs, list(casc.stage_lanes)
    r_card = _forward_on_card(casc, syn)
    assert casc.full_calls == 1 and casc.syncs == syncs
    assert casc.stage_lanes == [lanes[0] + 48] + lanes[1:]
    _same(r_card, r_cpu)


def test_guarded_qc_cascade_keeps_the_stages():
    """A cascade of kernel-B decoders given the high-p guard, and kernel D's
    serial cascade, which carries it: both take the full-depth path on the
    card, where the guard has nothing to skip, and keep the stages, with
    the guard firing, on the CPU. Both paths give the same results."""
    H = _H("lp04_0")
    casc = make_decoder(TannerGraph.build(H), DecoderConfig(
        max_iter=30, schedule="L"), layers=build_layers(H, "L"))
    guarded_b = Cascade(list(casc.decs), casc.stages, highp_guard=True)
    syn = _syndromes(7, H, 48, 0.12)
    for guarded in (guarded_b, _serial(H)):
        assert guarded.highp_guard and guarded.full_depth
        r_cpu = guarded(syn, PRIOR)
        assert guarded.guard_fired == 1 and guarded.syncs == 1
        assert guarded.full_calls == 0
        r_card = _forward_on_card(guarded, syn)
        assert guarded.full_calls == 1
        assert guarded.guard_fired == 1 and guarded.syncs == 1
        _same(r_card, r_cpu)


@pytest.mark.parametrize("kind,sched", [("MS", "L"), ("BP", "L"),
                                        ("MS", "S"), ("BP", "S")],
                         ids=["MS", "BP", "MS-S", "BP-S"])
def test_simulate_p_counts_the_same_on_both_paths(kind, sched, monkeypatch):
    """A seeded `simulate_p` on lp04_0 through kernel B's cascade (layered)
    or kernel D's (serial) counts the same through the full-depth path as
    through the stages."""
    c = get_code("lp04_0")
    cfg = SimConfig(shots=512, batch_size=256, dec_type=kind,
                    dec_iterations=30, dec_schedule=sched, rng_seed=7,
                    device="cpu")
    stages = simulate_p(c.Hx, c.Hz, 0.06, cfg)
    monkeypatch.setattr(Cascade, "forward", Cascade.forward_full)
    full = simulate_p(c.Hx, c.Hz, 0.06, cfg)
    assert full.counters == stages.counters
    assert full.avg_iterations_x == stages.avg_iterations_x
    assert full.avg_iterations_z == stages.avg_iterations_z


def test_group_cascade_head_counts_the_same_on_both_paths(monkeypatch):
    """The group cascade's head cascade (stages (4, 10) of MS-L-30) on the
    full-depth path: the run counts what it counts through the stages."""
    c = get_code("lp04_0")
    cfg = SimConfig(shots=512, batch_size=256, dec_type="MS",
                    dec_iterations=30, dec_schedule="L", rng_seed=5,
                    device="cpu")
    monkeypatch.setenv("QLDPC_GROUP_CASCADE", "1")
    stages = simulate_p(c.Hx, c.Hz, 0.08, cfg)
    monkeypatch.setattr(Cascade, "forward", Cascade.forward_full)
    full = simulate_p(c.Hx, c.Hz, 0.08, cfg)
    assert full.counters == stages.counters
    assert full.avg_iterations_x == stages.avg_iterations_x
