"""The port's simulate_p (CPU, plain versions) end to end: counters
bit-exact with a reference pipeline put together from the JAX package's own
functions over the same key chain, and qBLER within 4 sigma of the JAX
package's simulate_p."""

import dataclasses
import math

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
from qldpcsim_tpu.engine.classify import ClassifierStatic, classify_batch
from qldpcsim_tpu.engine.montecarlo import SimConfig as RefSimConfig
from qldpcsim_tpu.engine.montecarlo import simulate_p as ref_simulate_p
from qldpcsim_tpu.ops.ms_qc_pallas import make_ms_qc_decoder
from qldpcsim_tpu.ops.qc import detect_qc
from qldpcsim_tpu.parallel.mesh import chunk_keys

from qldpcsim_torch.engine.montecarlo import (
    ShotPipeline,
    SimConfig,
    _auto_batch,
    _tile_size,
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


def _reference_counters(Hx, Hz, p, shots, batch, seed, p_index, max_iter):
    """The reference engine's chunk body on its threefry path, with the
    Pallas kernel in interpret mode: chunk_keys -> sample_shot_tiles ->
    make_cascade(make_ms_qc_decoder) -> classify_batch."""
    n = Hx.shape[1]
    cfg = RefConfig(dec_type="MS", max_iter=max_iter, schedule="L")

    def decoder(H):
        st = detect_qc(H)

        def factory(graph, c, layers=None):
            return make_ms_qc_decoder(st, c, layers=layers, B_blk=32,
                                      interpret=True)

        return make_cascade(factory, RefGraph.build(H), cfg,
                            ref_build_layers(H, "L"))

    dec_x, dec_z = decoder(Hz), decoder(Hx)
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
    (dict(osd_order=2), NotImplementedError),
    (dict(validate_encoding=True), NotImplementedError),
    (dict(checkpoint_dir="ckpt"), NotImplementedError),
    (dict(device="mps"), ValueError),
])
def test_pipeline_raises_outside_the_slice(kw, err):
    c = get_code("lp04_0")
    with pytest.raises(err):
        ShotPipeline(c.Hx, c.Hz, SimConfig(dec_schedule="L", **{
            "device": "cpu", **kw}))


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = get_code("lp04_0")
    with pytest.raises(RuntimeError):
        ShotPipeline(c.Hx, c.Hz, SimConfig(dec_schedule="L", device="cuda"))
