"""The bf16 state of the QC decoders (`QLDPC_QC_DTYPE=bf16`; kernels B and
F, MS and BP) in the port's plain versions.

The semantics are the port's (ops/ms_qc_cuda.py): bf16 is the storage of
the carried state, every value computed in float32 from what it loads and
rounded once where it is stored. The reference's bf16 kernel has no
bit-exact twin: in interpret mode XLA keeps some intermediates in float32,
and its arithmetic is bf16 (its BP clamp 1 - eps rounds to 1.0, so
log((1 + th2) / (1 - th2)) overflows and its posterior fills with NaN).
So each case asserts the agreement rates it measured against the Pallas
kernel in interpret mode under the same flag (64 shots, numpy seed 1,
errors at p = 0.06, prior 0.02, 20 iterations, lp04_0), each threshold
just under the measured value, and the port's bf16 qBLER within 4 sigma of
its float32 qBLER. The sizes that decide kernel B's state place and kernel
F's selection follow the dtype, and the checkpoint identity names both
variants. Kernels B and F in bf16 against these plain versions on the
card: tests/test_torch_cuda.py."""

import math

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.ops.ms_qc_pallas import make_qc_decoder as ref_make_qc
from qldpcsim_tpu.ops.qc import detect_qc

from qldpcsim_torch.decoders import DecoderConfig, build_layers
from qldpcsim_torch.engine.montecarlo import (
    ShotPipeline, SimConfig, _ckpt_id, _decoder_choice, simulate_p)
from qldpcsim_torch.ops import flood_qc_cuda, ms_qc_cuda
from qldpcsim_torch.ops.qc import QCStructure

BF16 = torch.bfloat16


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


# (schedule, kind, kernel F): measured agreement of e_hat (whole shots)
# and n_iter, port bf16 against Pallas bf16 -> thresholds asserted
CASES = {
    # measured: 0.7656, 0.9531 (port bf16 against port float32: 0.81, 0.94)
    ("L", "MS", False): (0.75, 0.93),
    # measured: 0.7812, 0.9219 (against port float32: 0.86, 0.95)
    ("F", "MS", False): (0.76, 0.90),
    # measured: 0.0938, 0.5625: the reference's posterior is NaN on most
    # shots (its clamp rounds to 1.0); against port float32: 0.73, 0.92
    ("F", "BP", False): (0.07, 0.54),
    # measured: 0.7969, 0.9375 (against port float32: 0.88, 0.91)
    ("F", "MS", True): (0.78, 0.92),
}
SHOTS, P_ERR, PRIOR, ITERS = 64, 0.06, np.float32(0.02), 20


@pytest.fixture(scope="module")
def lp04():
    H = np.asarray(get_code("lp04_0").Hz) % 2
    return H, detect_qc(H), _syndromes(1, H, SHOTS, P_ERR)


@pytest.fixture(scope="module")
def pallas_bf16(lp04):
    """The Pallas kernels in interpret mode under QLDPC_QC_DTYPE=bf16, one
    run per case, made once (they take 3-48 s each)."""
    H, st, syn = lp04
    cache = {}

    def get(sched, kind, stacked):
        key = (sched, kind, stacked)
        if key not in cache:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("QLDPC_QC_DTYPE", "bf16")
                mp.setenv("QLDPC_QC_STACKED", "1" if stacked else "0")
                dec = ref_make_qc(
                    st, RefConfig(dec_type=kind, max_iter=ITERS,
                                  schedule=sched),
                    layers=ref_build_layers(H, sched), B_blk=SHOTS,
                    interpret=True, kind=kind)
                cache[key] = dec(syn, PRIOR)
        return cache[key]

    return get


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_bf16_agrees_with_pallas_bf16(case, lp04, pallas_bf16):
    sched, kind, stacked = case
    H, st, syn = lp04
    ref = pallas_bf16(*case)
    port = ms_qc_cuda.make_qc_decoder(
        st, DecoderConfig(dec_type=kind, max_iter=ITERS, schedule=sched),
        layers=build_layers(H, sched), dtype=BF16, stacked=stacked)
    assert port.stacked == stacked and port.state_dtype == BF16
    o = port(torch.from_numpy(syn), PRIOR)
    e_ok = (np.asarray(ref.e_hat) == o.e_hat.numpy()).all(axis=1).mean()
    it_ok = (np.asarray(ref.n_iter) == o.n_iter.numpy()).mean()
    want_e, want_it = CASES[case]
    assert e_ok >= want_e and it_ok >= want_it, (e_ok, it_ok)
    assert torch.isfinite(o.posterior).all()
    if kind == "BP":
        assert np.isnan(np.asarray(ref.posterior)).mean() > 0.5
    # the state is bf16: every posterior word is a bf16 value
    assert torch.equal(o.posterior, o.posterior.to(BF16).float())


@pytest.mark.parametrize("stacked", [False, True])
def test_bf16_plain_rounds_where_the_kernel_stores(stacked, lp04):
    """The posterior starts at the prior rounded to bf16 (no iteration
    run); zero syndromes converge at once, to bf16 values that differ from
    the float32 decode's."""
    H, st, _ = lp04
    syn = torch.zeros((3, H.shape[0]), dtype=torch.int8)
    lch = ms_qc_cuda.llr_prior(PRIOR)
    assert float(torch.tensor(lch).to(BF16).float()) != np.float32(lch)
    out = {}
    for dt in (BF16, torch.float32):
        start = ms_qc_cuda.make_qc_decoder(
            st, DecoderConfig(dec_type="MS", max_iter=0, schedule="F"),
            dtype=dt, stacked=stacked)(syn, PRIOR)
        assert (start.posterior == float(torch.tensor(lch).to(dt))).all()
        o = ms_qc_cuda.make_qc_decoder(
            st, DecoderConfig(dec_type="MS", max_iter=5, schedule="F"),
            dtype=dt, stacked=stacked)(syn, PRIOR)
        assert o.converged.all() and (o.n_iter == 1).all()
        out[dt] = o.posterior
    assert torch.equal(out[BF16], out[BF16].to(BF16).float())
    assert not torch.equal(out[BF16], out[torch.float32])


def test_bf16_qbler_within_4_sigma_of_f32(monkeypatch):
    c = get_code("lp04_0")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    shots, p = 2048, 0.08
    cfg = SimConfig(shots=shots, dec_type="MS", dec_iterations=20,
                    dec_schedule="L", rng_seed=2, device="cpu")
    f32 = simulate_p(Hx, Hz, p, cfg)
    monkeypatch.setenv("QLDPC_QC_DTYPE", "bf16")
    pipe = ShotPipeline(Hx, Hz, cfg)
    assert _decoder_choice(pipe.dec_x) == "QCDecoder:bf16"
    bf = simulate_p(Hx, Hz, p, cfg, pipeline=pipe)
    assert bf.counters != f32.counters
    for a, b in ((f32.qbler, bf.qbler), (f32.qbler_honest, bf.qbler_honest)):
        pool = (a + b) / 2
        sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
        assert abs(a - b) <= 4 * sigma, (a, b)
    assert 0.0 < bf.qbler < 1.0


def _lift(L, m_b, n_b, deg):
    shifts = np.full((m_b, n_b), -1)
    for i in range(m_b):
        shifts[i, [(3 * i + t) % n_b for t in range(deg)]] = [
            (i + 2 * t) % L for t in range(deg)]
    return QCStructure(L=L, shifts=shifts)


def test_bf16_sizes_decide_state_place_and_kernel_f():
    """A synthetic lift (L 128, 27 x 8 blocks, degree 8): in float32 a shot's
    state needs device memory under kernel B and is too large for kernel F;
    in bf16 it fits a block in both, and the decoder that asks for kernel F
    takes it."""
    st = _lift(128, 27, 8, 8)
    cfg = DecoderConfig(dec_type="MS", max_iter=4, schedule="F")
    n, E, m, S = 8 * 128, 27 * 8 * 128, 27 * 128, 27 * 8
    tables = 4 * (3 * S + 8 + 1)
    b32, b16 = (ms_qc_cuda.make_qc_decoder(st, cfg, dtype=dt, stacked=False)
                for dt in (torch.float32, BF16))
    # kernel B under F: posterior, messages, snapshot deltas, signs
    assert b32.state_words == n + 2 * E + m
    assert b16.state_words == (2 * (n + 2 * E) + 3) // 4 + m
    assert b32.state_on_device and not b16.state_on_device
    assert 4 * (b16.table_words + b16.state_words) <= ms_qc_cuda.MAX_SMEM
    # kernel F: posterior and messages in the dtype, deltas and signs f32
    t = b32.tabs
    assert flood_qc_cuda.smem_bytes(t) == 4 * (n + 2 * E + m) + tables
    assert flood_qc_cuda.smem_bytes(t, BF16) == (2 * (n + E) + 4 * (E + m)
                                                 + tables)
    assert not flood_qc_cuda.supports(st, t)
    assert flood_qc_cuda.supports(st, t, BF16)
    f32, f16 = (ms_qc_cuda.make_qc_decoder(st, cfg, dtype=dt, stacked=True)
                for dt in (torch.float32, BF16))
    assert not f32.stacked and f16.stacked
    # both bf16 decoders run here, their state rounded to bf16
    syn = torch.from_numpy(_syndromes(4, b32.H.numpy().astype(np.int64), 4,
                                      0.002))
    for dec in (b16, f16):
        post = dec(syn, 0.01).posterior
        assert torch.equal(post, post.to(BF16).float())


def test_bf16_layered_state_and_odd_sizes():
    """Kernel B's bf16 state is padded to a word: an odd count of carried
    values (lp04_0's 175 variables under L, no snapshot)."""
    H = np.asarray(get_code("lp04_0").Hz) % 2
    st = detect_qc(H)
    cfg = DecoderConfig(dec_type="MS", max_iter=4, schedule="L")
    d16 = ms_qc_cuda.make_qc_decoder(st, cfg, layers=build_layers(H, "L"),
                                     dtype=BF16)
    d32 = ms_qc_cuda.make_qc_decoder(st, cfg, layers=build_layers(H, "L"),
                                     dtype=torch.float32)
    t = d16.tabs
    carried = t.n + t.n_slots * t.L
    assert carried % 2 == 1 and d16.delta_slots == 0
    assert d16.state_words == (2 * carried + 3) // 4 + t.m
    assert d32.state_words == carried + t.m
    with pytest.raises(ValueError, match="state"):
        ms_qc_cuda.make_qc_decoder(st, cfg, dtype=torch.float16)


def test_checkpoint_identity_names_bf16_and_vec(monkeypatch):
    """`_decoder_choice` appends :bf16 and :vec, so the checkpoint identity
    differs with either flag and a resume with a flag flipped starts
    afresh; with neither flag it is what it was."""
    c = get_code("lp04_0")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    cfg = SimConfig(shots=256, dec_type="MS", dec_iterations=8,
                    dec_schedule="F", batch_size=128, rng_seed=1,
                    device="cpu")
    ids, choices = {}, {}
    for env in ({}, {"QLDPC_QC_DTYPE": "bf16"}, {"QLDPC_QC_VEC": "1"},
                {"QLDPC_QC_DTYPE": "bf16", "QLDPC_QC_VEC": "1"},
                {"QLDPC_QC_DTYPE": "f32"}):
        for k in ("QLDPC_QC_DTYPE", "QLDPC_QC_VEC", "QLDPC_QC_STACKED"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        pipe = ShotPipeline(Hx, Hz, cfg)
        key = tuple(sorted(env.items()))
        choices[key] = _decoder_choice(pipe.dec_x)
        ids[key] = _ckpt_id(pipe, cfg, 1, 0.05, 0)
    assert list(choices.values()) == [
        "QCDecoder", "QCDecoder:bf16", "QCDecoder:vec",
        "QCDecoder:bf16:vec", "QCDecoder"]
    assert len(set(ids.values())) == 4
    assert ids[()] == ids[(("QLDPC_QC_DTYPE", "f32"),)]
