"""The port's simulate_p and simulate (CPU, plain versions) end to end:
counters bit-exact with a reference pipeline put together from the JAX
package's own functions over the same key chain (min-sum under the layered
schedule, with and without OSD, and under the serial schedule on the Tanner
code), qBLER within 4 sigma of the JAX package's simulate_p (min-sum, BP
with OSD-2, serial min-sum), and checkpointed runs."""

import contextlib
import dataclasses
import io
import json
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpcsim_tpu.channel.depolarizing import sample_shot_tiles
from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import TannerGraph as RefGraph
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.decoders.cascade import make_cascade
from qldpcsim_tpu.decoders.osd import make_osd as ref_make_osd
from qldpcsim_tpu.engine.classify import ClassifierStatic, classify_batch
from qldpcsim_tpu.engine.montecarlo import SimConfig as RefSimConfig
from qldpcsim_tpu.engine.montecarlo import simulate_p as ref_simulate_p
from qldpcsim_tpu.ops.ms_qc_pallas import make_ms_qc_decoder
from qldpcsim_tpu.ops.qc import detect_qc
from qldpcsim_tpu.ops.seq_qc_pallas import make_ms_seq_qc_decoder
from qldpcsim_tpu.parallel.mesh import chunk_keys

from qldpcsim_torch.decoders.cascade import Cascade
from qldpcsim_torch.engine import montecarlo
from qldpcsim_torch.engine.montecarlo import (
    ShotPipeline,
    SimConfig,
    _auto_batch,
    _ckpt_id,
    _tile_size,
    simulate,
    simulate_p,
)
from qldpcsim_torch.engine.results import format_results_table


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layered_cascade(H, max_iter):
    """make_cascade(make_ms_qc_decoder), layered, Pallas in interpret mode."""
    st = detect_qc(H)
    cfg = RefConfig(dec_type="MS", max_iter=max_iter, schedule="L")

    def factory(graph, c, layers=None):
        return make_ms_qc_decoder(st, c, layers=layers, B_blk=32,
                                  interpret=True)

    return make_cascade(factory, RefGraph.build(H), cfg,
                        ref_build_layers(H, "L"))


def _serial_full_depth(H, max_iter):
    """The Pallas serial kernel in interpret mode at full depth, with no
    cascade around it (the cascade changes no result, and each stage would
    cost another ~25 s interpret-mode compile of the Tanner kernel)."""
    return make_ms_seq_qc_decoder(
        detect_qc(H), RefConfig(dec_type="MS", max_iter=max_iter,
                                schedule="S"),
        layers=ref_build_layers(H, "S"), B_blk=64, interpret=True)


def _reference_counters(Hx, Hz, p, shots, batch, seed, p_index, max_iter,
                        decoders=None):
    """The reference engine's chunk body on its threefry path, with the
    Pallas kernel in interpret mode: chunk_keys -> sample_shot_tiles ->
    decoder (make_cascade(make_ms_qc_decoder) unless `decoders` gives the X
    and Z sides' own) -> classify_batch."""
    n = Hx.shape[1]
    dec_x, dec_z = decoders or (_layered_cascade(Hz, max_iter),
                                _layered_cascade(Hx, max_iter))
    classifier = ClassifierStatic.build(Hx, Hz)
    Hx_T, Hz_T = Hx.T.astype(np.float32), Hz.T.astype(np.float32)

    @jax.jit
    def chunk(keys, p, n_valid):
        err_x, err_z, sy_z, sy_x = sample_shot_tiles(keys, p, n, 64, Hx_T,
                                                     Hz_T)
        valid = jnp.arange(batch) < n_valid
        prior = p / 3.0
        rx, rz = dec_x(sy_z, prior), dec_z(sy_x, prior)
        counts = classify_batch(classifier, err_x, err_z, rx.e_hat, rz.e_hat,
                                sy_z, sy_x, valid=valid)
        counts["nIterAccX"] = jnp.sum(jnp.where(valid, rx.n_iter, 0))
        counts["nIterAccZ"] = jnp.sum(jnp.where(valid, rz.n_iter, 0))
        return counts

    key = jax.random.fold_in(jax.random.PRNGKey(seed), p_index)
    tpc = batch // 64
    totals = {}
    for c in range(-(-shots // batch)):
        counts = jax.device_get(chunk(chunk_keys(key, c * tpc, tpc),
                                      jnp.float32(p),
                                      jnp.int32(min(batch, shots - c * batch))))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + int(v)
    return totals


def _reference_osd_counters(Hx, Hz, p, shots, batch, seed, max_iter, order):
    """The reference's chunk body with OSD, from its own functions:
    chunk_keys -> sample_shot_tiles -> make_ms_qc_decoder (layered, Pallas
    in interpret mode) -> make_osd(platform="cpu") over each side's
    decoder-failed shots -> classify_batch. max_iter <= 12, so no
    cascade."""
    n = Hx.shape[1]
    cfg = RefConfig(dec_type="MS", max_iter=max_iter, schedule="L")

    def decoder(H):
        return make_ms_qc_decoder(detect_qc(H), cfg,
                                  layers=ref_build_layers(H, "L"), B_blk=32,
                                  interpret=True)

    dec_x, dec_z = decoder(Hz), decoder(Hx)
    # OSD acts shot by shot: run it jitted over whole chunks and keep the
    # failed shots' results (one compile per side)
    osd_x = jax.jit(ref_make_osd(Hz, order, platform="cpu"))
    osd_z = jax.jit(ref_make_osd(Hx, order, platform="cpu"))
    classifier = ClassifierStatic.build(Hx, Hz)
    Hx_T, Hz_T = Hx.T.astype(np.float32), Hz.T.astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    tpc = batch // 64
    totals = {}
    for c in range(-(-shots // batch)):
        err_x, err_z, sy_z, sy_x = sample_shot_tiles(
            chunk_keys(key, c * tpc, tpc), jnp.float32(p), n, 64, Hx_T, Hz_T)
        valid = np.arange(batch) < min(batch, shots - c * batch)
        prior = jnp.float32(p) / 3.0
        ests = []
        for dec, osd, syn in ((dec_x, osd_x, sy_z), (dec_z, osd_z, sy_x)):
            r = dec(syn, prior)
            failed = ~np.asarray(r.converged) & valid
            e = np.where(failed[:, None],
                         np.asarray(osd(r.e_hat, syn, r.posterior)),
                         np.asarray(r.e_hat))
            ests.append((e, r.n_iter))
        counts = classify_batch(classifier, err_x, err_z, ests[0][0],
                                ests[1][0], sy_z, sy_x,
                                valid=jnp.asarray(valid))
        counts["nIterAccX"] = jnp.sum(jnp.where(valid, ests[0][1], 0))
        counts["nIterAccZ"] = jnp.sum(jnp.where(valid, ests[1][1], 0))
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + int(v)
    return totals


def _counters(res):
    return dict(res.counters,
                nIterAccX=round(res.avg_iterations_x * res.shots),
                nIterAccZ=round(res.avg_iterations_z * res.shots))


def test_simulate_p_counters_bit_exact_with_reference_pipeline():
    c = get_code("lp118_0")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    cfg = SimConfig(shots=200, dec_type="MS", dec_iterations=50,
                    dec_schedule="L", batch_size=128, rng_seed=4,
                    device="cpu")
    res = simulate_p(Hx, Hz, 0.05, cfg, p_index=1)
    ref = _reference_counters(Hx, Hz, 0.05, 200, 128, 4, 1, 50)
    assert _counters(res) == ref
    assert res.warm_shots == 72 and res.shots == 200
    assert ref["DecFailures_X"] + ref["DecFailures_Z"] > 0


def test_qbler_within_4_sigma_of_reference_simulate_p():
    c = get_code("lp04_0")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    shots, p = 3000, 0.08
    kw = dict(shots=shots, dec_type="MS", dec_iterations=30,
              dec_schedule="L", rng_seed=2)
    ref = ref_simulate_p(Hx, Hz, p, RefSimConfig(**kw, device="cpu"))
    res = simulate_p(Hx, Hz, p, SimConfig(**kw, device="cpu"))
    for a, b in ((ref.qbler, res.qbler), (ref.qbler_honest, res.qbler_honest)):
        pool = (a + b) / 2
        sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
        assert abs(a - b) <= 4 * sigma, (a, b)
    assert 0.0 < res.qbler < 1.0
    assert "SIMULATION RESULTS" in format_results_table([res])


def test_osd_counters_bit_exact_with_reference_pipeline():
    """MS-L + OSD-2 on lp04_0 at a depth and p where the decoder fails often:
    the 9 counters equal the reference chain's, so OSD ran on shared
    posteriors with the same reliability order and gave the same
    estimates."""
    c = get_code("lp04_0")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    cfg = SimConfig(shots=200, dec_type="MS", dec_iterations=8,
                    dec_schedule="L", osd_order=2, batch_size=128,
                    rng_seed=6, device="cpu")
    pipe = ShotPipeline(Hx, Hz, cfg)
    res = simulate_p(Hx, Hz, 0.08, cfg, pipeline=pipe)
    ref = _reference_osd_counters(Hx, Hz, 0.08, 200, 128, 6, 8, 2)
    assert _counters(res) == ref
    assert pipe.osd_shots["x"] > 0 and pipe.osd_shots["z"] > 0
    # OSD turned some decoder failures into successes
    no_osd = simulate_p(Hx, Hz, 0.08, dataclasses.replace(cfg, osd_order=-1))
    assert res.counters["decSuccessExact"] > \
        no_osd.counters["decSuccessExact"]


def test_bp_osd_qbler_within_4_sigma_of_reference_simulate_p():
    """BP-F + OSD-2 on lp04_0: BP's tanh and log differ in the last ulp
    between XLA and torch on the CPU (ROADMAP queue 3), so qBLER is held to
    4 sigma of the JAX package's simulate_p, not bit for bit."""
    c = get_code("lp04_0")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    shots, p = 1024, 0.08
    kw = dict(shots=shots, dec_type="BP", dec_iterations=20,
              dec_schedule="F", osd_order=2, batch_size=512, rng_seed=5)
    ref = ref_simulate_p(Hx, Hz, p, RefSimConfig(**kw, device="cpu"))
    res = simulate_p(Hx, Hz, p, SimConfig(**kw, device="cpu"))
    for a, b in ((ref.qbler, res.qbler), (ref.qbler_honest, res.qbler_honest)):
        pool = (a + b) / 2
        sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
        assert abs(a - b) <= 4 * sigma, (a, b)
    assert 0.0 < res.qbler < 1.0


def _lp04():
    c = get_code("lp04_0")
    return np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2


def _sum_chunks(pipe, keys, p, n_valids, body):
    tot = {}
    for k, nv in zip(keys, n_valids):
        for name, v in body(k, p, nv).items():
            tot[name] = tot.get(name, 0) + int(v)
    return tot


@pytest.mark.parametrize("dec_type,sched,iters", [("MS", "L", 8),
                                                  ("BP", "F", 12)])
@pytest.mark.parametrize("pending_max", [8192, 16])
def test_group_osd_pass_equals_in_chunk_osd(monkeypatch, dec_type, sched,
                                            iters, pending_max):
    """The group-level OSD pass of `_multi_chunk_body` gives the counters of
    the self-contained chunks, whatever the flush bound: OSD acts shot by
    shot, and one pipeline decodes both ways (so BP is exact here too)."""
    Hx, Hz = _lp04()
    cfg = SimConfig(shots=5 * 64, dec_type=dec_type, dec_iterations=iters,
                    dec_schedule=sched, osd_order=2, batch_size=64,
                    rng_seed=6, device="cpu")
    pipe = ShotPipeline(Hx, Hz, cfg)
    key = montecarlo.fold_in(montecarlo.prng_key(6), 0)
    keys = montecarlo.chunk_keys(key, 0, 5).reshape(5, 1, 2)
    n_valids = [64, 64, 64, 64, 40]
    ref = _sum_chunks(pipe, keys, 0.08, n_valids, pipe._chunk_body)
    in_chunk_shots = dict(pipe.osd_shots)
    pipe.osd_shots, pipe.osd_syncs = {"x": 0, "z": 0}, 0
    flushes = []
    finish = pipe._osd_group_finish
    monkeypatch.setattr(pipe, "_osd_group_finish",
                        lambda pend: flushes.append(sum(
                            d["cx"].shape[0] for d in pend)) or finish(pend))
    monkeypatch.setattr(montecarlo, "_OSD_PENDING_MAX", pending_max)
    out = {k: int(v) for k, v in
           pipe._multi_chunk_body(keys, 0.08, n_valids).items()}
    assert out == ref
    assert pipe.osd_shots == in_chunk_shots and min(in_chunk_shots.values())
    if pending_max == 16:
        # bounded: a pass as soon as 16 records wait, never a chunk later
        assert len(flushes) > 1 and max(flushes) < 16 + 64
    else:
        assert len(flushes) == 1
    # one sync per chunk for the compaction, one per side per pass
    assert pipe.osd_syncs == 5 + 2 * len(flushes)


def test_group_osd_counters_bit_exact_with_reference_pipeline():
    """MS-L + OSD-2 over 4 chunks (the first self-contained, three through
    the group-level pass): the 9 counters equal the reference chain's."""
    Hx, Hz = _lp04()
    cfg = SimConfig(shots=4 * 64 - 10, dec_type="MS", dec_iterations=8,
                    dec_schedule="L", osd_order=2, batch_size=64,
                    rng_seed=6, device="cpu")
    pipe = ShotPipeline(Hx, Hz, cfg)
    res = simulate_p(Hx, Hz, 0.08, cfg, pipeline=pipe)
    assert _counters(res) == _reference_osd_counters(Hx, Hz, 0.08,
                                                     4 * 64 - 10, 64, 6, 8, 2)
    assert pipe.osd_shots["x"] > 0 and pipe.osd_shots["z"] > 0


def test_group_osd_ms_counters_equal_reference_simulate_p():
    """Steane, MS-L-8 + OSD-2, 5 chunks: the JAX package's `simulate_p`
    (its deferred OSD with the in-chunk overflow) and the port's give the
    same 9 counters."""
    c = get_code("steane")
    kw = dict(shots=300, dec_type="MS", dec_iterations=8, dec_schedule="L",
              osd_order=2, batch_size=64, rng_seed=3)
    ref = ref_simulate_p(c.Hx, c.Hz, 0.1, RefSimConfig(**kw, device="cpu"))
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(**kw, device="cpu"))
    res = simulate_p(c.Hx, c.Hz, 0.1, pipe.cfg, pipeline=pipe)
    assert _counters(res) == _counters(ref)
    assert pipe.osd_shots["x"] > 0 and pipe.osd_shots["z"] > 0


def test_group_osd_bp_qbler_within_4_sigma_of_reference_simulate_p():
    """BP-F + OSD-2 on lp04_0 over 8 chunks, the last 7 through the
    group-level pass: qBLER within 4 sigma of the JAX package's."""
    Hx, Hz = _lp04()
    shots, p = 1024, 0.08
    kw = dict(shots=shots, dec_type="BP", dec_iterations=20,
              dec_schedule="F", osd_order=2, batch_size=128, rng_seed=7)
    ref = ref_simulate_p(Hx, Hz, p, RefSimConfig(**kw, device="cpu"))
    res = simulate_p(Hx, Hz, p, SimConfig(**kw, device="cpu"))
    for a, b in ((ref.qbler, res.qbler), (ref.qbler_honest, res.qbler_honest)):
        pool = (a + b) / 2
        sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
        assert abs(a - b) <= 4 * sigma, (a, b)


@pytest.mark.parametrize("kw", [
    dict(dec_type="MS", dec_iterations=8, dec_schedule="L", osd_order=2),
    dict(dec_type="BP", dec_iterations=12, dec_schedule="F"),
    dict(dec_type="BF"),
])
def test_validate_encoding_leaves_the_counters(kw):
    """Frame invariance end to end: encode -> corrupt -> extract gives the
    counters of the frame-free channel, and the same errors and syndromes
    chunk by chunk."""
    Hx, Hz = _lp04()
    cfg = SimConfig(shots=200, batch_size=64, rng_seed=4, device="cpu", **kw)
    plain = ShotPipeline(Hx, Hz, cfg)
    framed = ShotPipeline(Hx, Hz, dataclasses.replace(
        cfg, validate_encoding=True))
    assert plain.encoder is None and framed.encoder is not None
    keys = montecarlo.chunk_keys(montecarlo.prng_key(4), 0, 1)
    for a, b in zip(plain._sample_chunk(keys, 0.07),
                    framed._sample_chunk(keys, 0.07)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    a = simulate_p(Hx, Hz, 0.07, plain.cfg, pipeline=plain)
    b = simulate_p(Hx, Hz, 0.07, framed.cfg, pipeline=framed)
    assert _counters(a) == _counters(b)
    assert _ckpt_id(plain, plain.cfg, 4, 0.07, 0) != _ckpt_id(
        framed, framed.cfg, 4, 0.07, 0)


def test_validate_encoding_counters_equal_reference_simulate_p():
    c = get_code("steane")
    kw = dict(shots=300, dec_type="MS", dec_iterations=8, dec_schedule="L",
              batch_size=64, rng_seed=2, validate_encoding=True)
    ref = ref_simulate_p(c.Hx, c.Hz, 0.08, RefSimConfig(**kw, device="cpu"))
    res = simulate_p(c.Hx, c.Hz, 0.08, SimConfig(**kw, device="cpu"))
    assert _counters(res) == _counters(ref)


def test_counters_do_not_depend_on_the_batch():
    """The per-tile key contract: any chunking of the same tile stream gives
    the same counters."""
    c = get_code("lp04_0")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    base = SimConfig(shots=384, dec_type="MS", dec_iterations=20,
                     dec_schedule="F", rng_seed=8, device="cpu")
    a = simulate_p(Hx, Hz, 0.06, dataclasses.replace(base, batch_size=384))
    b = simulate_p(Hx, Hz, 0.06, dataclasses.replace(base, batch_size=128))
    assert _counters(a) == _counters(b)


def test_batch_and_tile_sizes():
    assert _auto_batch(544, 262144) == 4096
    assert _auto_batch(2000, 262144) == 2048
    assert _auto_batch(544, 200) == 192
    assert _auto_batch(544, 10) == 64
    assert _tile_size(4096) == 64 and _tile_size(96) == 32


@pytest.mark.parametrize("kw,err", [
    (dict(dec_type="BF", bf_residual="or"), ValueError),
    (dict(dec_type="MS", osd_order=7), ValueError),
    (dict(dec_type="GN"), ValueError),
    (dict(device="mps"), ValueError),
])
def test_pipeline_raises_outside_the_slice(kw, err):
    c = get_code("lp04_0")
    with pytest.raises(err):
        ShotPipeline(c.Hx, c.Hz, SimConfig(dec_schedule="L", **{
            "device": "cpu", **kw}))


@pytest.mark.parametrize("dec_type", ["BF", "NG"])
def test_bf_and_ng_pipelines_take_no_osd_and_no_schedule(dec_type):
    """BF and NG give no posterior: `osd_order` is ignored for them, as in
    the reference, and so is the schedule."""
    c = get_code("steane")
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(
        dec_type=dec_type, osd_order=2, dec_schedule="?", device="cpu"))
    assert not pipe.use_osd
    assert type(pipe.dec_x).__name__ == f"{dec_type}Decoder"


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = get_code("lp04_0")
    with pytest.raises(RuntimeError):
        ShotPipeline(c.Hx, c.Hz, SimConfig(dec_schedule="L", device="cuda"))


# --- config 4 at a small size: Tanner code, MS, serial schedule, 30
# iterations, a p-sweep through `simulate` -------------------------------

DATA = Path(__file__).resolve().parents[1] / "data"
C4_P = [0.02, 0.07]
C4_SHOTS, C4_BATCH, C4_SEED = 128, 64, 0


@pytest.fixture(scope="module")
def config4():
    """One run of the port's `simulate` on the CPU; its printed output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = simulate(str(DATA / "Hx_T.npy"), str(DATA / "Hz_T.npy"),
                           C4_P, shots=C4_SHOTS, decType="MS",
                           decIterations=30, decSchedule="S",
                           rngSeed=C4_SEED, batch_size=C4_BATCH,
                           device="cpu")
    return results, out.getvalue()


@pytest.fixture(scope="module")
def config4_reference_decoders():
    c = get_code("tanner")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    return Hx, Hz, (_serial_full_depth(Hz, 30), _serial_full_depth(Hx, 30))


@pytest.mark.parametrize("i", range(len(C4_P)))
def test_config4_counters_bit_exact_with_reference_chain(
        config4, config4_reference_decoders, i):
    """The 9 counters of each p-point equal those of a chain of the JAX
    package's own functions around its Pallas serial kernel (interpret
    mode) on the key branch p_index = position: tolerance 0."""
    results, _ = config4
    Hx, Hz, decoders = config4_reference_decoders
    ref = _reference_counters(Hx, Hz, C4_P[i], C4_SHOTS, C4_BATCH, C4_SEED,
                              i, 30, decoders=decoders)
    assert _counters(results[i]) == ref
    assert ref["nIterAccX"] > C4_SHOTS      # the decoder iterated


@pytest.mark.parametrize("i", range(len(C4_P)))
def test_config4_qbler_within_4_sigma_of_reference_simulate_p(config4, i):
    """Against the JAX package's simulate_p on the CPU, which takes its XLA
    row-sequential path there (a different float32 association, so held to
    4 sigma and not bit for bit)."""
    results, _ = config4
    c = get_code("tanner")
    ref = ref_simulate_p(c.Hx, c.Hz, C4_P[i], RefSimConfig(
        shots=C4_SHOTS, dec_type="MS", dec_iterations=30, dec_schedule="S",
        rng_seed=C4_SEED, batch_size=C4_BATCH, device="cpu"), p_index=i)
    res = results[i]
    for a, b in ((ref.qbler, res.qbler), (ref.qbler_honest, res.qbler_honest)):
        pool = (a + b) / 2
        sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / C4_SHOTS)
        assert abs(a - b) <= 4 * sigma, (a, b)
    assert abs(ref.avg_iterations_x - res.avg_iterations_x) <= 0.5


def test_simulate_returns_one_result_per_p_and_prints_the_table(config4):
    results, printed = config4
    assert [r.p for r in results] == C4_P
    assert all(r.shots == C4_SHOTS for r in results)
    assert printed.rstrip("\n") == format_results_table(results)
    assert "SIMULATION RESULTS" in printed and "2.00e-02" in printed
    # p_index = position: each p-point ran on its own key branch
    c = get_code("tanner")
    cfg = SimConfig(shots=C4_SHOTS, dec_type="MS", dec_iterations=30,
                    dec_schedule="S", rng_seed=C4_SEED, batch_size=C4_BATCH,
                    device="cpu")
    pipe = ShotPipeline(c.Hx, c.Hz, cfg)
    assert isinstance(pipe.dec_x, Cascade) and pipe.dec_x.highp_guard
    again = simulate_p(c.Hx, c.Hz, C4_P[0], cfg, pipeline=pipe, p_index=0)
    assert _counters(again) == _counters(results[0])
    other = simulate_p(c.Hx, c.Hz, C4_P[0], cfg, pipeline=pipe, p_index=1)
    assert _counters(other) != _counters(results[0])
    assert results[1].qbler > results[0].qbler
    with pytest.raises(ValueError):
        simulate(str(DATA / "Hx_T.npy"), str(DATA / "Hz_T.npy"), [1.5],
                 device="cpu")


# --- checkpoints ---------------------------------------------------------

def _ckpt_cfg(tmp_path, **kw):
    base = dict(shots=7 * 64, dec_type="MS", dec_iterations=20,
                dec_schedule="L", batch_size=64, rng_seed=9, device="cpu",
                checkpoint_dir=str(tmp_path))
    return SimConfig(**{**base, **kw})


class _Killed(Exception):
    pass


@pytest.mark.parametrize("k", [1, 2, 3])
def test_checkpointed_run_resumes_after_a_kill(tmp_path, monkeypatch, k):
    """A run killed after k key groups and started again gives the counters
    of an uninterrupted run, and decodes only the chunks that were left."""
    c = get_code("lp04_0")
    monkeypatch.setattr(montecarlo, "_KEY_GROUP_CHUNKS", 2)  # 4 groups
    whole = simulate_p(c.Hx, c.Hz, 0.07, _ckpt_cfg(tmp_path, checkpoint_dir=None))
    saves = []
    real_save = montecarlo.CheckpointStore.save

    def save_then_die(self, run_id, counters, chunks_done):
        real_save(self, run_id, counters, chunks_done)
        saves.append(chunks_done)
        if len(saves) == k:
            raise _Killed()

    monkeypatch.setattr(montecarlo.CheckpointStore, "save", save_then_die)
    cfg = _ckpt_cfg(tmp_path)
    with pytest.raises(_Killed):
        simulate_p(c.Hx, c.Hz, 0.07, cfg)
    assert saves == [2 * (g + 1) for g in range(k)]
    files = list(tmp_path.glob("p0_MSL_*.json"))
    assert len(files) == 1
    assert json.loads(files[0].read_text())["chunks_done"] == 2 * k
    monkeypatch.setattr(montecarlo.CheckpointStore, "save", real_save)
    chunks = []
    real_body = ShotPipeline._chunk_body

    def counting_body(self, keys, p, n_valid):
        chunks.append(n_valid)
        return real_body(self, keys, p, n_valid)

    monkeypatch.setattr(ShotPipeline, "_chunk_body", counting_body)
    resumed = simulate_p(c.Hx, c.Hz, 0.07, cfg)
    assert len(chunks) == 7 - 2 * k
    assert _counters(resumed) == _counters(whole)
    # a finished run's checkpoint answers without decoding anything
    chunks.clear()
    again = simulate_p(c.Hx, c.Hz, 0.07, cfg)
    assert chunks == [] and _counters(again) == _counters(whole)


@pytest.mark.parametrize("change", [
    dict(rng_seed=10), dict(shots=6 * 64), dict(dec_iterations=21),
    dict(dec_schedule="F"), dict(osd_order=0), dict(batch_size=128),
    "p", "p_index", "code",
])
def test_changed_run_misses_the_checkpoint(tmp_path, change):
    """Seed, p, shots, the code or any decoder knob is part of the
    checkpoint's identity: a changed run starts from zero."""
    c = get_code("lp04_0")
    cfg = _ckpt_cfg(tmp_path, shots=128)
    simulate_p(c.Hx, c.Hz, 0.07, cfg)
    assert len(list(tmp_path.glob("*.json"))) == 1
    Hx, Hz, p, p_index, cfg2 = c.Hx, c.Hz, 0.07, 0, cfg
    if change == "p":
        p = 0.071
    elif change == "p_index":
        p_index = 1
    elif change == "code":
        other = get_code("lp04_1")
        Hx, Hz = other.Hx, other.Hz
    else:
        cfg2 = dataclasses.replace(cfg, **change)
    pipe, pipe2 = ShotPipeline(c.Hx, c.Hz, cfg), ShotPipeline(Hx, Hz, cfg2)
    assert _ckpt_id(pipe, cfg, 9, 0.07, 0) != _ckpt_id(
        pipe2, cfg2, cfg2.rng_seed, p, p_index)
    res = simulate_p(Hx, Hz, p, cfg2, pipeline=pipe2, p_index=p_index)
    assert len(list(tmp_path.glob("*.json"))) == 2
    fresh = simulate_p(Hx, Hz, p, dataclasses.replace(
        cfg2, checkpoint_dir=None), p_index=p_index)
    assert _counters(res) == _counters(fresh)


def test_kernel_choice_is_part_of_the_checkpoint_identity(tmp_path,
                                                          monkeypatch):
    """Whether flooding runs on the per-slot or the slot-stacked kernel is
    read from the environment when the decoder is built, and the two give
    different counters; so the choice is part of the checkpoint's identity,
    and a run resumed under the other choice starts afresh instead of
    adding its chunks to the other stream's counts."""
    c = get_code("lp04_0")
    cfg = _ckpt_cfg(tmp_path, shots=192, dec_schedule="F")
    monkeypatch.delenv("QLDPC_QC_STACKED", raising=False)
    pipe = ShotPipeline(c.Hx, c.Hz, cfg)
    monkeypatch.setenv("QLDPC_QC_STACKED", "1")
    pipe_f = ShotPipeline(c.Hx, c.Hz, cfg)
    assert not pipe.dec_x.decs[0].stacked and pipe_f.dec_x.decs[0].stacked
    assert _ckpt_id(pipe, cfg, 9, 0.07, 0) != _ckpt_id(pipe_f, cfg, 9,
                                                       0.07, 0)
    # a finished run under the per-slot kernel leaves its checkpoint
    monkeypatch.delenv("QLDPC_QC_STACKED")
    first = simulate_p(c.Hx, c.Hz, 0.07, cfg)
    assert len(list(tmp_path.glob("*.json"))) == 1
    chunks = []
    real_body = ShotPipeline._chunk_body

    def counting_body(self, keys, p, n_valid):
        chunks.append(n_valid)
        return real_body(self, keys, p, n_valid)

    monkeypatch.setattr(ShotPipeline, "_chunk_body", counting_body)
    # the same run again answers from it without decoding
    again = simulate_p(c.Hx, c.Hz, 0.07, cfg)
    assert chunks == [] and _counters(again) == _counters(first)
    # under the other kernel the run decodes every chunk anew
    monkeypatch.setenv("QLDPC_QC_STACKED", "1")
    other = simulate_p(c.Hx, c.Hz, 0.07, cfg)
    assert len(chunks) == 3 and len(list(tmp_path.glob("*.json"))) == 2
    fresh = simulate_p(c.Hx, c.Hz, 0.07, dataclasses.replace(
        cfg, checkpoint_dir=None))
    assert _counters(other) == _counters(fresh)


# --- codes with no circulant lift: configs 1-3 at a small size, and a
# column-permuted lp04_0 through the general-H decoder --------------------

def _ref_decoders(Hx, Hz, make):
    """(dec_x, dec_z) of the reference chain: X errors through Hz."""
    return make(Hz), make(Hx)


def _ref_mxu_cascade(H, max_iter, sched):
    from qldpcsim_tpu.decoders.ms_mxu import make_ms_mxu_decoder

    cfg = RefConfig(dec_type="MS", max_iter=max_iter, schedule=sched)
    return make_cascade(make_ms_mxu_decoder, RefGraph.build(H), cfg,
                        ref_build_layers(H, sched))


def _ref_gh_cascade(H, max_iter):
    """make_cascade(make_gh_decoder), layered, Pallas in interpret mode."""
    from qldpcsim_tpu.ops.general_h_pallas import make_gh_decoder

    cfg = RefConfig(dec_type="MS", max_iter=max_iter, schedule="L")

    def factory(graph, c, layers=None):
        return make_gh_decoder(graph.H, c, layers=layers, B_blk=64,
                               interpret=True)

    return make_cascade(factory, RefGraph.build(H), cfg,
                        ref_build_layers(H, "L"))


@pytest.mark.parametrize("p_index,p", enumerate([0.01, 0.03, 0.05]))
def test_config2_steane_counters_bit_exact_with_reference_chain(p_index, p):
    """Config 2 (Steane, MS-L-50) at 2048 shots per p: the incidence decoder
    in the cascade; the 9 counters equal those of a chain of the JAX
    package's own functions around its incidence decoder: tolerance 0 (one
    delta per variable and layer, so the products sum nothing)."""
    c = get_code("steane")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    cfg = SimConfig(shots=2048, dec_type="MS", dec_iterations=50,
                    dec_schedule="L", batch_size=1024, rng_seed=0,
                    device="cpu")
    pipe = ShotPipeline(Hx, Hz, cfg)
    assert isinstance(pipe.dec_x, Cascade)
    assert type(pipe.dec_x.decs[0]).__name__ == "MxuDecoder"
    res = simulate_p(Hx, Hz, p, cfg, pipeline=pipe, p_index=p_index)
    ref = _reference_counters(
        Hx, Hz, p, 2048, 1024, 0, p_index, 50,
        decoders=_ref_decoders(Hx, Hz,
                               lambda H: _ref_mxu_cascade(H, 50, "L")))
    assert _counters(res) == ref
    assert ref["nIterAccX"] > 2048 and ref["logicalErrors_X"] >= 0


@pytest.mark.parametrize("dec_type", ["BF", "NG"])
@pytest.mark.parametrize("p_index,p", enumerate([0.01, 0.03]))
def test_config3_bicycle_counters_bit_exact_with_reference_chain(
        dec_type, p_index, p):
    """Config 3 (bicycle, BF-50 and NG) at 512 shots per p: integer
    arithmetic, so the 9 counters equal the reference chain's: tolerance 0.
    NG's average counts its 0-step shots."""
    from qldpcsim_tpu.decoders.bf import make_bf_decoder
    from qldpcsim_tpu.decoders.ng import make_ng_decoder

    c = get_code("bicycle")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    cfg = SimConfig(shots=512, dec_type=dec_type, dec_iterations=50,
                    dec_schedule="F", batch_size=256, rng_seed=0,
                    device="cpu")
    res = simulate_p(Hx, Hz, p, cfg, p_index=p_index)
    make = make_bf_decoder if dec_type == "BF" else make_ng_decoder
    ref = _reference_counters(
        Hx, Hz, p, 512, 256, 0, p_index, 50,
        decoders=_ref_decoders(Hx, Hz, lambda H: make(
            RefGraph.build(H), RefConfig(dec_type=dec_type))))
    assert _counters(res) == ref
    assert ref["DecFailures_X"] > 0 and ref["decSuccessExact"] > 0
    if dec_type == "NG":   # some shots have a zero syndrome: 0 steps
        assert res.avg_iterations_x < 146


@pytest.mark.parametrize("p_index,p", enumerate([0.01, 0.05]))
def test_config1_shor_bp_qbler_within_4_sigma_of_reference_simulate_p(
        p_index, p):
    """Config 1 (Shor, BP-F-99, 1000 shots per p, uncut): BP's tanh and log
    differ in the last ulp between XLA and torch, so qBLER is held to 4
    sigma of the JAX package's simulate_p. Shor's 2 x 9 Hx decodes as it
    is (the reference pads it to 8 rows for its TPU compiler)."""
    c = get_code("shor")
    kw = dict(shots=1000, dec_type="BP", dec_iterations=99,
              dec_schedule="F", rng_seed=0)
    ref = ref_simulate_p(c.Hx, c.Hz, p, RefSimConfig(**kw, device="cpu"),
                         p_index=p_index)
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(**kw, device="cpu"))
    assert type(pipe.dec_z.decs[0]).__name__ == "MxuDecoder"
    assert pipe.dec_z.decs[0].m == 2 and pipe.batch == 960
    res = simulate_p(c.Hx, c.Hz, p, pipe.cfg, pipeline=pipe, p_index=p_index)
    for a, b in ((ref.qbler, res.qbler), (ref.qbler_honest, res.qbler_honest)):
        pool = (a + b) / 2
        sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / 1000)
        assert abs(a - b) <= 4 * sigma, (a, b)
    assert abs(ref.avg_iterations_x - res.avg_iterations_x) <= 0.2
    assert res.warm_shots == 40


@pytest.fixture(scope="module")
def permuted_lp04():
    """lp04_0 with one column permutation on both sides: the same code up
    to a relabelling of qubits, with no circulant lift left."""
    c = get_code("lp04_0")
    perm = np.random.default_rng(4).permutation(c.Hx.shape[1])
    Hx = (np.asarray(c.Hx) % 2)[:, perm].astype(np.int8)
    Hz = (np.asarray(c.Hz) % 2)[:, perm].astype(np.int8)
    assert detect_qc(Hx) is None and detect_qc(Hz) is None
    assert not ((Hx.astype(np.int64) @ Hz.T) % 2).any()
    return Hx, Hz


def test_general_h_counters_bit_exact_with_reference_chain(permuted_lp04):
    """MS-L-50 on the permuted lp04_0 (588 edge slots: the general-H decoder
    by itself, in the cascade): the 9 counters equal those of a chain of
    the JAX package's own functions around its general-H Pallas kernel in
    interpret mode: tolerance 0."""
    Hx, Hz = permuted_lp04
    cfg = SimConfig(shots=300, dec_type="MS", dec_iterations=50,
                    dec_schedule="L", batch_size=128, rng_seed=3,
                    device="cpu")
    pipe = ShotPipeline(Hx, Hz, cfg)
    assert isinstance(pipe.dec_x, Cascade)
    assert all(type(d).__name__ == "GHDecoder" for d in pipe.dec_x.decs)
    res = simulate_p(Hx, Hz, 0.06, cfg, pipeline=pipe, p_index=1)
    ref = _reference_counters(
        Hx, Hz, 0.06, 300, 128, 3, 1, 50,
        decoders=_ref_decoders(Hx, Hz, lambda H: _ref_gh_cascade(H, 50)))
    assert _counters(res) == ref
    assert ref["DecFailures_X"] + ref["DecFailures_Z"] > 0
    assert ref["nIterAccX"] > 300


def test_general_h_by_path_and_against_the_lifted_code(permuted_lp04,
                                                        tmp_path):
    """The reference's input mode: the matrices as .npy files through
    `simulate`. A relabelling of qubits changes no statistic: qBLER within 4
    sigma of lp04_0's own (kernel B's plain version) at the same settings,
    and of the JAX package's simulate_p on the permuted matrices."""
    Hx, Hz = permuted_lp04
    np.save(tmp_path / "Hx.npy", Hx)
    np.save(tmp_path / "Hz.npy", Hz)
    shots, p = 2048, 0.07
    kw = dict(shots=shots, dec_type="MS", dec_iterations=30,
              dec_schedule="L", rng_seed=2)
    with contextlib.redirect_stdout(io.StringIO()):
        res = simulate(str(tmp_path / "Hx.npy"), str(tmp_path / "Hz.npy"),
                       [p], shots=shots, decType="MS", decIterations=30,
                       decSchedule="L", rngSeed=2, device="cpu")[0]
    c = get_code("lp04_0")
    lifted = simulate_p(c.Hx, c.Hz, p, SimConfig(**kw, device="cpu"))
    ref = ref_simulate_p(Hx, Hz, p, RefSimConfig(**kw, device="cpu"))
    for other in (lifted, ref):
        for a, b in ((other.qbler, res.qbler),
                     (other.qbler_honest, res.qbler_honest)):
            pool = (a + b) / 2
            sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
            assert abs(a - b) <= 4 * sigma, (a, b)
    assert 0.0 < res.qbler < 1.0
