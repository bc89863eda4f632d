"""`SimConfig.sort_window` in the port on the CPU: accepted and ignored.
The reference orders each window of a chunk's shots by syndrome weight so
that its 128-lane blocks finish together; the port's kernels run a block
per shot, so it takes the setting, and `QLDPC_SORT_WINDOW`, and changes
nothing. The counters equal the default run's and the JAX package's run
with the same window, with and without OSD and with a partial last
chunk."""

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

from qldpcsim_torch.engine.montecarlo import SimConfig, simulate_p


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lp04():
    return get_code("lp04_0")


def _counters(r):
    return dict(r.counters, avg_x=r.avg_iterations_x, avg_z=r.avg_iterations_z)


MS50 = dict(shots=1500, dec_type="MS", dec_iterations=50, rng_seed=21,
            batch_size=512)


@pytest.mark.parametrize("p,base", [
    (0.05, MS50),
    (0.07, dict(shots=1024, dec_type="BP", dec_iterations=16, rng_seed=9,
                batch_size=512, osd_order=1)),
], ids=["ms50-partial-chunk", "bp16-osd1"])
def test_sort_window_leaves_every_counter(monkeypatch, lp04, p, base):
    """The twin of the JAX package's test_sort_window_bit_exact: MS-50 with
    a partial last chunk and BP-16 + OSD-1, with sort_window 256 and 0.
    For MS-50 the event counters also equal the JAX package's run with
    sort_window 256. Its iteration sums are held to 2 iterations: on the
    CPU the JAX package's `simulate_p` does not take its QC kernel
    (`_pallas_platform_ok` is false there, so `make_decoder` routes the
    code to the incidence decoder `ms_mxu`), while the port follows the
    Pallas kernel's association of the float32 sums on every device; at
    this seed the Z sums differ by 2 of about 6500 with any window. The
    port equals the QC kernel's own chain bit for bit, iteration sums
    included (`test_ms_f50_equals_the_qc_kernel_chain`)."""
    monkeypatch.delenv("QLDPC_SORT_WINDOW", raising=False)
    r_256 = simulate_p(lp04.Hx, lp04.Hz, p,
                       SimConfig(sort_window=256, device="cpu", **base))
    r_0 = simulate_p(lp04.Hx, lp04.Hz, p,
                     SimConfig(sort_window=0, device="cpu", **base))
    assert _counters(r_256) == _counters(r_0)
    if base["dec_type"] == "MS":
        ref = ref_simulate_p(lp04.Hx, lp04.Hz, p, RefSimConfig(
            sort_window=256, dispatch_chunks=3, **base))
        assert r_256.counters == ref.counters
        for a, b in ((r_256.avg_iterations_x, ref.avg_iterations_x),
                     (r_256.avg_iterations_z, ref.avg_iterations_z)):
            assert abs(a - b) * base["shots"] <= 2.0 + 1e-6


def _flooding_cascade(H, max_iter):
    """make_cascade(make_ms_qc_decoder), flooding, Pallas in interpret mode:
    the QC kernel the JAX package takes on the TPU."""
    cfg = RefConfig(dec_type="MS", max_iter=max_iter, schedule="F")
    st = detect_qc(H)

    def factory(graph, c, layers=None):
        return make_ms_qc_decoder(st, c, layers=layers, B_blk=32,
                                  interpret=True)

    return make_cascade(factory, RefGraph.build(H), cfg,
                        ref_build_layers(H, "F"))


def test_ms_f50_equals_the_qc_kernel_chain(monkeypatch, lp04):
    """The MS-50 run above (flooding, p 0.05, seed 21, 1500 shots in
    512-shot chunks, the last partial) against the JAX package's chunk body
    put together with its QC kernel in interpret mode (chunk_keys ->
    sample_shot_tiles -> the cascade of make_ms_qc_decoder ->
    classify_batch): every counter equal, the iteration sums included."""
    monkeypatch.delenv("QLDPC_QC_STACKED", raising=False)
    p, shots, batch, seed = 0.05, MS50["shots"], MS50["batch_size"], 21
    Hx, Hz = np.asarray(lp04.Hx) % 2, np.asarray(lp04.Hz) % 2
    n = Hx.shape[1]
    dec_x, dec_z = _flooding_cascade(Hz, 50), _flooding_cascade(Hx, 50)
    classifier = ClassifierStatic.build(Hx, Hz)
    Hx_T, Hz_T = Hx.T.astype(np.float32), Hz.T.astype(np.float32)

    @jax.jit
    def chunk(keys, p, n_valid):
        err_x, err_z, sy_z, sy_x = sample_shot_tiles(keys, p, n, 64, Hx_T,
                                                     Hz_T)
        valid = jnp.arange(batch) < n_valid
        rx, rz = dec_x(sy_z, p / 3.0), dec_z(sy_x, p / 3.0)
        counts = classify_batch(classifier, err_x, err_z, rx.e_hat, rz.e_hat,
                                sy_z, sy_x, valid=valid)
        counts["nIterAccX"] = jnp.sum(jnp.where(valid, rx.n_iter, 0))
        counts["nIterAccZ"] = jnp.sum(jnp.where(valid, rz.n_iter, 0))
        return counts

    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    tpc = batch // 64
    ref = {}
    for c in range(-(-shots // batch)):
        counts = jax.device_get(chunk(
            chunk_keys(key, c * tpc, tpc), jnp.float32(p),
            jnp.int32(min(batch, shots - c * batch))))
        for k, v in counts.items():
            ref[k] = ref.get(k, 0) + int(v)
    r = simulate_p(lp04.Hx, lp04.Hz, p, SimConfig(device="cpu", **MS50))
    port = dict(r.counters, nIterAccX=round(r.avg_iterations_x * shots),
                nIterAccZ=round(r.avg_iterations_z * shots))
    assert port == ref
    assert ref["DecFailures_X"] + ref["DecFailures_Z"] > 0


@pytest.fixture(scope="module")
def small_default(lp04):
    """A 300-shot MS-50 run in 256-shot chunks (the second partial) with
    the default window."""
    return _counters(simulate_p(lp04.Hx, lp04.Hz, 0.06, SimConfig(
        shots=300, dec_type="MS", dec_iterations=50, rng_seed=4,
        batch_size=256, device="cpu")))


@pytest.mark.parametrize("window,env", [
    (0, None), (64, None), (128, None), (256, None), (384, None),
    (-1, "256"), (256, "-1"),
])
def test_every_window_is_accepted_and_ignored(monkeypatch, lp04,
                                              small_default, window, env):
    """Whatever the reference would make of the window (on, off, not whole
    128-shot blocks, larger than the chunk) and of QLDPC_SORT_WINDOW, the
    port builds and runs, with the default run's counters."""
    if env is None:
        monkeypatch.delenv("QLDPC_SORT_WINDOW", raising=False)
    else:
        monkeypatch.setenv("QLDPC_SORT_WINDOW", env)
    r = simulate_p(lp04.Hx, lp04.Hz, 0.06, SimConfig(
        shots=300, dec_type="MS", dec_iterations=50, rng_seed=4,
        batch_size=256, sort_window=window, device="cpu"))
    assert _counters(r) == small_default
