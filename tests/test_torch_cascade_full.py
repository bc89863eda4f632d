"""The one-launch-or-stages choice on the CPU. `make_decoder` returns a
side's full-depth decoder bare where one launch suffices
(`decoders._one_launch`: a decoder that reports `one_launch`, kernel B's
`QCDecoder` when not `stacked` and kernel D's `SeqQCDecoder`, on a CUDA
device), and the straggler cascade's stages everywhere else, the plain
versions included. Here both run through the plain versions: the bare
full-depth decoder's results equal the stages' (the serial schedule's with
the high-p guard firing) bit for bit, and a run routed as on the card
(`_one_launch` patched) counts what the stages count, with the same
decoder choice and checkpoint id."""

import numpy as np
import pytest
import torch

from qldpcsim_torch import decoders
from qldpcsim_torch.codes import get_code
from qldpcsim_torch.decoders import (
    DecoderConfig,
    TannerGraph,
    _one_launch,
    build_layers,
    make_decoder,
)
from qldpcsim_torch.decoders.cascade import Cascade, make_cascade
from qldpcsim_torch.engine.montecarlo import (
    ShotPipeline,
    SimConfig,
    _ckpt_id,
    _decoder_choice,
    simulate_p,
)
from qldpcsim_torch.ops.ms_qc_cuda import QCDecoder, make_qc_decoder
from qldpcsim_torch.ops.qc import detect_qc
from qldpcsim_torch.ops.seq_qc_cuda import SeqQCDecoder

CARD = torch.device("cuda")


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


def _route_as_on_card(monkeypatch):
    """`make_decoder` decides as it would for a CUDA device, while the
    decoders it builds stay on the CPU."""
    real = decoders._one_launch
    monkeypatch.setattr(decoders, "_one_launch",
                        lambda dec, device: real(dec, CARD))


@pytest.mark.parametrize("chunk", list(CHUNKS))
@pytest.mark.parametrize("kind_name", list(KINDS))
def test_full_depth_equals_stages_and_full_decode(kind_name, chunk):
    """The bare full-depth decoder, which the card takes, and the stages on
    the same chunk: results bit for bit equal; the stages count the batch
    as the head's lanes and sync once per stage reached."""
    H = _H()
    p_err, fails = CHUNKS[chunk]
    syn = _syndromes(11, H, 48, p_err)
    casc, full = _decoders(kind_name, H)
    assert isinstance(casc, Cascade) and isinstance(full, QCDecoder)
    assert _one_launch(full, CARD) and not _one_launch(full, "cpu")
    r_casc = casc(syn, PRIOR)
    r_full = full(syn, PRIOR)
    _same(r_casc, r_full)
    head_fail = int((r_full.n_iter > casc.stages[0][0]).sum())
    assert {"none": head_fail == 0, "some": 0 < head_fail < 48,
            "all": head_fail == 48}[fails]
    assert casc.stage_lanes[:2] == [48, head_fail]
    assert casc.syncs == (1 if head_fail == 0 else 2)


@pytest.mark.parametrize("kind_name", list(KINDS))
def test_partial_chunk(kind_name):
    """A full chunk of 64 and a partial one of 40 whose tail is padding
    (a chunk with n_valid < B): the stages give the full-depth decoder's
    results, and their lanes add up over both calls."""
    H = _H()
    casc, full = _decoders(kind_name, H)
    syn = _syndromes(5, H, 64, 0.06)
    part = syn[:40].clone()
    part[30:] = 0        # the tail of a partial chunk: nothing to decode
    for s in (syn, part):
        _same(casc(s, PRIOR), full(s, PRIOR))
    assert casc.stage_lanes[0] == 104


@pytest.mark.parametrize("qc", [dict(dtype=torch.bfloat16), dict(vec=True)],
                         ids=["bf16", "vec"])
def test_full_depth_equals_stages_for_kernel_b_variants(qc):
    """The bf16 state and the stacked-update writeback (MS-L-50): one launch
    suffices for them too, and the full-depth decoder equals the stages
    bit for bit."""
    H = _H()
    casc, full = _decoders("MS-L-50", H, **qc)
    assert _one_launch(full, CARD)
    assert full.vec == casc.decs[0].vec == qc.get("vec", False)
    assert full.state_dtype == qc.get("dtype", torch.float32)
    syn = _syndromes(9, H, 48, 0.06)
    _same(full(syn, PRIOR), casc(syn, PRIOR))
    assert casc.syncs == 2


def test_the_plain_version_runs_the_stages():
    """On the CPU `make_decoder` keeps the stages for kernel B's plain
    version, which runs its batch in lockstep, so the cascade still pays
    there; on the card the same decoder would run alone."""
    H = _H("lp04_0")
    casc = make_decoder(TannerGraph.build(H), DecoderConfig(
        max_iter=30, schedule="L"), layers=build_layers(H, "L"))
    assert isinstance(casc, Cascade)
    assert _one_launch(casc.decs[-1], CARD)
    assert not _one_launch(casc.decs[-1], "cpu")
    syn = _syndromes(3, H, 32, 0.08)
    r = casc(syn, PRIOR)
    assert casc.syncs >= 1 and casc.stage_lanes[1] > 0
    _same(r, casc.decs[-1](syn, PRIOR))


def test_stage_plan_and_head_are_kept():
    """Kernel B's cascade keeps the plan and the stage decoders (the head
    first, whose type, state and beta name the side's decoder, as the
    full-depth decoder's do)."""
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
    casc(syn, PRIOR)
    lanes = list(casc.stage_lanes)
    assert lanes[0] == 32
    casc.stage_lanes = [0] * len(casc.stages)
    casc(syn, PRIOR)
    assert casc.stage_lanes == lanes


def _serial(H, kind="MS"):
    return make_decoder(TannerGraph.build(H), DecoderConfig(
        dec_type=kind, max_iter=30, schedule="S"), layers=build_layers(H, "S"))


# the serial schedule at p 0.10 (the Tanner cell's point): shots a chunk
SERIAL_SHOTS = {"lp04_0": 48, "tanner": 16}


@pytest.mark.parametrize("chunk", ["full", "partial"])
@pytest.mark.parametrize("code", list(SERIAL_SHOTS))
def test_serial_full_depth_equals_guarded_stages(code, chunk):
    """A serial-schedule MS cascade (kernel D's plain version, 4 -> 10 ->
    30) at p 0.10: its full-depth decoder, which the card takes alone,
    gives the e_hat, n_iter, converged and posterior of the stages bit for
    bit, where the high-p guard fires and sends the tail straight to full
    depth; also on a partial chunk whose last quarter is padding."""
    H = _H(code)
    n = SERIAL_SHOTS[code]
    syn = _syndromes(13, H, n, 0.10)
    if chunk == "partial":
        n = 3 * n // 4
        syn = syn[:n].clone()
        syn[n - n // 4:] = 0
    casc = _serial(H)
    full = casc.decs[-1]
    assert casc.highp_guard and _one_launch(full, CARD)
    r = full(syn, PRIOR)
    _same(r, casc(syn, PRIOR))
    head_fail = int((r.n_iter > casc.stages[0][0]).sum())
    assert head_fail > (2 * n) // 3
    assert casc.guard_fired == 1 and casc.syncs == 1
    assert casc.stage_lanes == [n, 0, head_fail]


def _general(H):
    perm = np.random.default_rng(4).permutation(H.shape[1])
    Hp = H[:, perm]
    return make_decoder(TannerGraph.build(Hp), DecoderConfig(
        max_iter=30, schedule="L", impl="gh"),
        layers=build_layers(Hp, "L")), Hp


@pytest.mark.parametrize("kernel", ["E", "F"])
def test_other_kernels_keep_the_stages(kernel, monkeypatch):
    """Kernels E and F keep the stages on the card too, a host sync per
    stage reached, though each shot leaves their launch at its convergence
    as in kernels B and D: no benchmark cell measures them yet."""
    _route_as_on_card(monkeypatch)
    H = _H("lp04_0")
    if kernel == "E":
        casc, H = _general(H)
    else:
        monkeypatch.setenv("QLDPC_QC_STACKED", "1")  # read when built
        casc = make_decoder(TannerGraph.build(H), DecoderConfig(
            max_iter=30, schedule="F"), layers=build_layers(H, "F"))
        assert all(d.stacked for d in casc.decs)
    assert isinstance(casc, Cascade) and not casc.highp_guard
    assert not any(_one_launch(d, CARD) for d in casc.decs)
    syn = _syndromes(6, H, 48, 0.06)
    r = casc(syn, PRIOR)
    assert casc.syncs >= 1 and casc.stage_lanes[0] == 48
    _same(r, casc.decs[-1](syn, PRIOR))


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_kernel_d_takes_the_full_depth_path(kind, monkeypatch):
    """Kernel D's side (serial schedule, 30 iterations) is its full-depth
    decoder alone when routed as on the card, with no cascade and so no
    host sync; on the CPU it runs the guarded stages, with the same
    results."""
    H = _H("lp04_0")
    casc = _serial(H, kind)
    assert isinstance(casc, Cascade) and casc.highp_guard
    assert all(d.kind == kind for d in casc.decs)
    syn = _syndromes(6, H, 48, 0.06)
    r_cpu = casc(syn, PRIOR)
    assert casc.syncs >= 1
    _route_as_on_card(monkeypatch)
    full = _serial(H, kind)
    assert isinstance(full, SeqQCDecoder)
    assert full.kind == kind and full.max_iter == 30
    _same(full(syn, PRIOR), r_cpu)


def test_guarded_qc_cascade_keeps_the_stages():
    """A cascade of kernel-B decoders given the high-p guard, and kernel D's
    serial cascade, which carries it: on the CPU both run the stages with
    the guard firing, and give the results of their full-depth decoder,
    which alone would run on the card."""
    H = _H("lp04_0")
    casc = make_decoder(TannerGraph.build(H), DecoderConfig(
        max_iter=30, schedule="L"), layers=build_layers(H, "L"))
    guarded_b = Cascade(list(casc.decs), casc.stages, highp_guard=True)
    syn = _syndromes(7, H, 48, 0.12)
    for guarded in (guarded_b, _serial(H)):
        assert guarded.highp_guard and _one_launch(guarded.decs[-1], CARD)
        r_cpu = guarded(syn, PRIOR)
        assert guarded.guard_fired == 1 and guarded.syncs == 1
        _same(guarded.decs[-1](syn, PRIOR), r_cpu)


@pytest.mark.parametrize("kind,sched", [("MS", "L"), ("BP", "L"),
                                        ("MS", "S"), ("BP", "S")],
                         ids=["MS", "BP", "MS-S", "BP-S"])
def test_simulate_p_counts_the_same_on_both_paths(kind, sched, monkeypatch):
    """A seeded `simulate_p` on lp04_0 through kernel B (layered) or kernel
    D (serial) counts the same with each side's full-depth decoder alone,
    as on the card, as through the cascade's stages."""
    c = get_code("lp04_0")
    cfg = SimConfig(shots=512, batch_size=256, dec_type=kind,
                    dec_iterations=30, dec_schedule=sched, rng_seed=7,
                    device="cpu")
    stages = simulate_p(c.Hx, c.Hz, 0.06, cfg)
    monkeypatch.setattr(decoders, "_one_launch", lambda dec, device: True)
    pipe = ShotPipeline(c.Hx, c.Hz, cfg)
    assert not isinstance(pipe.dec_x, Cascade)
    assert not isinstance(pipe.dec_z, Cascade)
    full = simulate_p(c.Hx, c.Hz, 0.06, cfg, pipeline=pipe)
    assert full.counters == stages.counters
    assert full.avg_iterations_x == stages.avg_iterations_x
    assert full.avg_iterations_z == stages.avg_iterations_z


def test_group_cascade_head_counts_the_same_on_both_paths(monkeypatch):
    """The group cascade (MS-L-30: a bare 10-iteration head, a bare
    full-depth tail) counts what the in-chunk cascade counts, with the
    pipeline's sides routed as on the CPU or as on the card."""
    c = get_code("lp04_0")
    cfg = SimConfig(shots=512, batch_size=256, dec_type="MS",
                    dec_iterations=30, dec_schedule="L", rng_seed=5,
                    device="cpu")
    in_chunk = simulate_p(c.Hx, c.Hz, 0.08, cfg)
    monkeypatch.setenv("QLDPC_GROUP_CASCADE", "1")
    stages = simulate_p(c.Hx, c.Hz, 0.08, cfg)
    monkeypatch.setattr(decoders, "_one_launch", lambda dec, device: True)
    full = simulate_p(c.Hx, c.Hz, 0.08, cfg)
    assert full.counters == stages.counters == in_chunk.counters
    assert (full.avg_iterations_x == stages.avg_iterations_x
            == in_chunk.avg_iterations_x)


# each side's decoder: (schedule, the environment read when it is built)
CHOICES = {"B f32": ("L", {}), "B bf16": ("L", {"QLDPC_QC_DTYPE": "bf16"}),
           "B vec": ("L", {"QLDPC_QC_VEC": "1"}), "D": ("S", {})}


@pytest.mark.parametrize("variant", list(CHOICES))
def test_bare_decoder_names_the_side_as_the_cascade(variant, monkeypatch):
    """A pipeline whose sides are the bare full-depth decoders (as on the
    card) names its decoders as the cascade's first stage names them, so
    its checkpoint id is the cascade's and a checkpoint written by either
    resumes under the other."""
    sched, env = CHOICES[variant]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    c = get_code("lp04_0")
    cfg = SimConfig(shots=256, batch_size=256, dec_type="MS",
                    dec_iterations=50, dec_schedule=sched, rng_seed=3,
                    device="cpu")
    staged = ShotPipeline(c.Hx, c.Hz, cfg)
    _route_as_on_card(monkeypatch)
    bare = ShotPipeline(c.Hx, c.Hz, cfg)
    kernel = SeqQCDecoder if variant == "D" else QCDecoder
    for s, b in ((staged.dec_x, bare.dec_x), (staged.dec_z, bare.dec_z)):
        assert isinstance(s, Cascade) and type(b) is kernel
        assert _decoder_choice(b) == _decoder_choice(s)
        assert b.beta == s.decs[0].beta
    assert _decoder_choice(bare.dec_x).endswith(
        {"B f32": "QCDecoder", "B bf16": ":bf16", "B vec": ":vec",
         "D": "SeqQCDecoder"}[variant])
    assert (_ckpt_id(bare, cfg, 3, 0.05, 0)
            == _ckpt_id(staged, cfg, 3, 0.05, 0))
