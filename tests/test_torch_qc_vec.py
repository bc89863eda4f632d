"""The stacked-update writeback of the QC min-sum decoder (`QLDPC_QC_VEC=1`,
the reference's `one_block_row_vec`) in the port's plain version, bit for
bit with the Pallas kernel in interpret mode under the same flag: e_hat,
n_iter, converged and the posterior. The writeback stores R + delta with
delta = fma(coef * sign, mag, -R) (XLA:CPU contracts the product into the
subtraction), so its posterior is not the per-slot path's; the tests show
both. The flag is read when the decoder is built and taken only for MS
without the per-layer check (and never by kernel F); an MS-F + OSD-1 run
under it gives the JAX chain's counters. Kernel B with the flag against
this plain version on the card: tests/test_torch_cuda.py."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpcsim_tpu.channel.depolarizing import sample_shot_tiles
from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.decoders.osd import make_osd as ref_make_osd
from qldpcsim_tpu.engine.classify import ClassifierStatic, classify_batch
from qldpcsim_tpu.ops.ms_qc_pallas import make_ms_qc_decoder
from qldpcsim_tpu.ops.qc import detect_qc
from qldpcsim_tpu.parallel.mesh import chunk_keys

from qldpcsim_torch.decoders import DecoderConfig, build_layers
from qldpcsim_torch.engine.montecarlo import (
    ShotPipeline, SimConfig, _decoder_choice, simulate_p)
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


def _port(st, H, sched, vec, **kw):
    return ms_qc_cuda.make_qc_decoder(
        st, DecoderConfig(dec_type=kw.pop("kind", "MS"), max_iter=20,
                          schedule=sched, **kw),
        layers=build_layers(H, sched), vec=vec)


@pytest.mark.parametrize("code,sched", [
    ("lp04_0", "F"), ("lp04_0", "L"), ("lp118_0", "F")])
def test_plain_vec_equals_pallas_interpret(code, sched, monkeypatch):
    H = np.asarray(get_code(code).Hz) % 2
    st = detect_qc(H)
    syn = _syndromes(1, H, 64, 0.06)
    p = np.float32(0.06) / np.float32(3.0)
    monkeypatch.setenv("QLDPC_QC_VEC", "1")
    ref = make_ms_qc_decoder(
        st, RefConfig(dec_type="MS", max_iter=20, schedule=sched),
        layers=ref_build_layers(H, sched), B_blk=64, interpret=True)(syn, p)
    port = ms_qc_cuda.make_qc_decoder(
        st, DecoderConfig(dec_type="MS", max_iter=20, schedule=sched),
        layers=build_layers(H, sched))
    assert port.vec
    o = port(torch.from_numpy(syn), p)
    assert np.array_equal(np.asarray(ref.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(ref.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(ref.converged), o.converged.numpy())
    assert np.array_equal(np.asarray(ref.posterior), o.posterior.numpy())
    # the per-slot path: the same decisions on these shots (not on every
    # shot of a large batch), another posterior
    slot = _port(st, H, sched, vec=False)(torch.from_numpy(syn), p)
    assert torch.equal(slot.e_hat, o.e_hat)
    assert torch.equal(slot.n_iter, o.n_iter)
    assert not torch.equal(slot.posterior, o.posterior)
    assert o.converged.any() and not o.converged.all()


@pytest.mark.parametrize("why", ["BP", "per-layer check", "kernel F"])
def test_flag_ignored_outside_the_reference_condition(why, monkeypatch):
    """Under QLDPC_QC_VEC=1 the decoder takes the per-slot writeback for BP,
    for the check after every layer group and for kernel F, as the
    reference does, and decodes as a decoder built without the flag."""
    H = np.asarray(get_code("lp04_0").Hz) % 2
    st = detect_qc(H)
    kw, sched = {"BP": ({"kind": "BP"}, "F"),
                 "per-layer check": ({"qc_check_every": "layer"}, "L"),
                 "kernel F": ({}, "F")}[why]
    monkeypatch.setenv("QLDPC_QC_VEC", "1")
    if why == "kernel F":
        monkeypatch.setenv("QLDPC_QC_STACKED", "1")
    flagged = _port(st, H, sched, vec=None, **dict(kw))
    monkeypatch.delenv("QLDPC_QC_VEC")
    plain = _port(st, H, sched, vec=None, **dict(kw))
    assert not flagged.vec and not plain.vec
    assert flagged.stacked == plain.stacked == (why == "kernel F")
    assert flagged.track_mis == (why == "per-layer check")
    syn = torch.from_numpy(_syndromes(2, H, 16, 0.06))
    a, b = flagged(syn, 0.02), plain(syn, 0.02)
    assert torch.equal(a.posterior, b.posterior)
    assert torch.equal(a.n_iter, b.n_iter)
    # and an MS flooding decoder built under the flag takes it
    monkeypatch.setenv("QLDPC_QC_VEC", "1")
    monkeypatch.delenv("QLDPC_QC_STACKED", raising=False)
    assert _port(st, H, "F", vec=None).vec


def _reference_vec_osd_counters(Hx, Hz, p, shots, batch, seed, max_iter,
                                order):
    """The reference's chunk body from its own functions, MS-F under
    QLDPC_QC_VEC=1 (Pallas in interpret mode) -> make_osd over each side's
    decoder-failed shots -> classify_batch. max_iter <= 12: no cascade."""
    n = Hx.shape[1]
    cfg = RefConfig(dec_type="MS", max_iter=max_iter, schedule="F")

    def decoder(H):
        return make_ms_qc_decoder(detect_qc(H), cfg,
                                  layers=ref_build_layers(H, "F"), B_blk=64,
                                  interpret=True)

    dec_x, dec_z = decoder(Hz), decoder(Hx)
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


def test_vec_osd_counters_equal_the_jax_chain(monkeypatch):
    """OSD orders columns by the posterior, so the writeback's posterior
    reaches the counters: MS-F-8 + OSD-1 under the flag, bit for bit."""
    monkeypatch.setenv("QLDPC_QC_VEC", "1")
    c = get_code("lp04_0")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    cfg = SimConfig(shots=200, dec_type="MS", dec_iterations=8,
                    dec_schedule="F", osd_order=1, batch_size=128, rng_seed=6,
                    device="cpu")
    pipe = ShotPipeline(Hx, Hz, cfg)
    assert [_decoder_choice(pipe.dec_x), _decoder_choice(pipe.dec_z)] \
        == ["QCDecoder:vec"] * 2
    res = simulate_p(Hx, Hz, 0.08, cfg, pipeline=pipe)
    ref = _reference_vec_osd_counters(Hx, Hz, 0.08, 200, 128, 6, 8, 1)
    got = dict(res.counters,
               nIterAccX=round(res.avg_iterations_x * res.shots),
               nIterAccZ=round(res.avg_iterations_z * res.shots))
    assert got == ref
    assert pipe.osd_shots["x"] + pipe.osd_shots["z"] > 0


def test_ms_qc_ctypes_signature_matches_the_source():
    """The wrapper's argtypes for `ms_qc_decode` (with the bf16 and vec
    flags) follow the C signature in csrc/ms_qc.cu, type by type."""
    src = (Path(ms_qc_cuda.__file__).parent.parent / "csrc"
           / "ms_qc.cu").read_text()
    sig = re.search(r"int ms_qc_decode\(([^)]*)\)", src).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float,
             "long": ctypes.c_longlong}
    want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
            for p in (q.strip() for q in sig.split(","))]
    assert ms_qc_cuda.ARGTYPES == want
