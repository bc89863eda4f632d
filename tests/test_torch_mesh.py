"""Shot-sharded runs of the port (`parallel/mesh.py`, `simulate_p` with a
mesh) on CPU slots: counters bit for bit with the JAX package's
`simulate_p` on a mesh of the same size and with the port unmeshed (k = 1,
2, 4 slots; min-sum, min-sum + OSD, and a serial-schedule case at a p high
enough that the cascade's high-p guard fires in one layout and not in the
other), BP bit for bit with the port unmeshed and within 4 sigma of the JAX
package, a partial last chunk with empty slots, two processes over gloo
against one, and the pieces: `multihost_init`, `make_mesh`, the counter
all-reduce, the exec mode, rank 0's checkpoints and builds, and the launch
wrappers' current-device check."""

import dataclasses
import inspect
import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.engine.montecarlo import SimConfig as RefSimConfig
from qldpcsim_tpu.engine.montecarlo import simulate_p as ref_simulate_p
from qldpcsim_tpu.parallel import make_mesh as ref_make_mesh

from qldpcsim_torch.engine import montecarlo
from qldpcsim_torch.engine.montecarlo import ShotPipeline, SimConfig, simulate_p
from qldpcsim_torch.ops import _build
from qldpcsim_torch.parallel import mesh as mesh_mod
from qldpcsim_torch.parallel.mesh import (
    Mesh,
    allreduce_counters_host,
    local_mesh_rows,
    make_mesh,
    multihost_init,
)
from qldpcsim_torch.utils.checkpoint import CheckpointStore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counters(r):
    return dict(r.counters, nIterAccX=round(r.avg_iterations_x * r.shots),
                nIterAccZ=round(r.avg_iterations_z * r.shots))


def _cpu_mesh(k):
    return make_mesh(["cpu"] * k)


# (code, p, SimConfig fields): batch % (64 * 4) == 0, so every layout has
# 64-shot tiles and the same global tile stream
CASES = {
    # min-sum, layered, in the cascade (4 iterations, then 20 at 1/8);
    # 1000 shots: the last chunk is partial
    "MS": ("steane", 0.05, dict(shots=1000, dec_type="MS",
                                dec_iterations=20, dec_schedule="L",
                                rng_seed=3, batch_size=512)),
    # min-sum + OSD-2, each slot's own group-level OSD pass
    "MS+OSD": ("steane", 0.1, dict(shots=1000, dec_type="MS",
                                   dec_iterations=8, dec_schedule="L",
                                   osd_order=2, rng_seed=3, batch_size=512)),
    # serial, 30 iterations: the cascade with its high-p guard (heavy when
    # more than 2/3 of a batch fails the head); it fires on side Z of two
    # of four 256-shot slots, on one of two 512-shot slots, and not on the
    # 1024-shot batch
    "guard": ("shor", 0.2, dict(shots=1024, dec_type="MS", dec_iterations=30,
                                dec_schedule="S", rng_seed=5,
                                batch_size=1024)),
}


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_meshed_counters_equal_the_jax_mesh_and_the_unmeshed_run(case, k):
    code, p, kw = CASES[case]
    c = get_code(code)
    ref = ref_simulate_p(c.Hx, c.Hz, p, RefSimConfig(
        mesh=ref_make_mesh(jax.devices()[:k]), **kw))
    whole = ShotPipeline(c.Hx, c.Hz, SimConfig(device="cpu", **kw))
    unmeshed = simulate_p(c.Hx, c.Hz, p, whole.cfg, pipeline=whole)
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(mesh=_cpu_mesh(k), **kw))
    assert (pipe.n_dev, pipe.per_dev, pipe.tile) == (
        k, kw["batch_size"] // k, 64)
    res = simulate_p(c.Hx, c.Hz, p, pipe.cfg, pipeline=pipe)
    assert _counters(res) == _counters(ref) == _counters(unmeshed)
    assert res.warm_shots == unmeshed.warm_shots
    assert res.counters["DecFailures_X"] + res.counters["DecFailures_Z"] + \
        res.counters["logicalErrors_X"] > 0
    if case == "MS+OSD":
        assert sum(s.osd_shots["x"] + s.osd_shots["z"]
                   for s in pipe.slots) > 0
    if case == "guard":
        fired = [s.dec_z.guard_fired for s in pipe.slots]
        assert whole.dec_z.guard_fired == 0
        assert (sum(fired) > 0) == (k > 1), fired


@pytest.mark.parametrize("k", [2, 4])
def test_bp_meshed_equals_unmeshed_and_is_within_4_sigma_of_jax(k):
    """BP + OSD-1: bit for bit with the port unmeshed (its tanh and log are
    elementwise, so a shot's result does not depend on the batch it is
    in); within 4 sigma of the JAX package's mesh, whose transcendentals
    round differently."""
    c = get_code("lp04_0")
    shots, p = 1024, 0.05
    kw = dict(shots=shots, dec_type="BP", dec_iterations=8, rng_seed=5,
              osd_order=1, batch_size=512)
    unmeshed = simulate_p(c.Hx, c.Hz, p, SimConfig(device="cpu", **kw))
    res = simulate_p(c.Hx, c.Hz, p, SimConfig(mesh=_cpu_mesh(k), **kw))
    assert _counters(res) == _counters(unmeshed)
    ref = ref_simulate_p(c.Hx, c.Hz, p, RefSimConfig(
        mesh=ref_make_mesh(jax.devices()[:k]), **kw))
    for a, b in ((ref.qbler, res.qbler), (ref.qbler_honest, res.qbler_honest)):
        pool = (a + b) / 2
        sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
        assert abs(a - b) <= 4 * sigma, (a, b)
    assert 0.0 < res.qbler < 1.0


def test_partial_last_chunk_skips_its_empty_slots(monkeypatch):
    """712 shots in 512-shot chunks over 4 slots of 128: the last chunk
    gives slot 0 128 shots, slot 1 72 and slots 2 and 3 none; those two are
    not run, and the counters are the unmeshed run's."""
    c = get_code("steane")
    kw = dict(shots=712, dec_type="MS", dec_iterations=10, rng_seed=23,
              batch_size=512)
    unmeshed = simulate_p(c.Hx, c.Hz, 0.03, SimConfig(device="cpu", **kw))
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(mesh=_cpu_mesh(4), **kw))
    calls = {i: [] for i in range(4)}
    for i, slot in enumerate(pipe.slots):
        body = slot._multi_chunk_body

        def counted(keys, p, n_valids, _i=i, _body=body):
            calls[_i].append(list(n_valids))
            return _body(keys, p, n_valids)

        monkeypatch.setattr(slot, "_multi_chunk_body", counted)
    pipe.run_slots = mesh_mod.per_device_multi_chunk_fn(
        pipe.mesh, [s._multi_chunk_body for s in pipe.slots],
        montecarlo._COUNTER_KEYS)
    res = simulate_p(c.Hx, c.Hz, 0.03, pipe.cfg, pipeline=pipe)
    assert _counters(res) == _counters(unmeshed)
    assert calls == {0: [[128], [128]], 1: [[128], [72]], 2: [[128]],
                     3: [[128]]}


def test_a_meshed_pipeline_runs_any_shot_count():
    """A pipeline built for one run serves runs of other lengths: the valid
    shots are clipped to the run's own end."""
    c = get_code("steane")
    kw = dict(dec_type="MS", dec_iterations=10, rng_seed=2, batch_size=256)
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(shots=256, mesh=_cpu_mesh(2),
                                              **kw))
    for shots in (900, 100):
        res = simulate_p(c.Hx, c.Hz, 0.05, SimConfig(
            shots=shots, mesh=pipe.mesh, **kw), pipeline=pipe)
        assert _counters(res) == _counters(simulate_p(
            c.Hx, c.Hz, 0.05, SimConfig(shots=shots, device="cpu", **kw)))


def test_partial_chunk_with_a_tile_smaller_than_64_conserves_shots():
    """Shor, 200 shots in chunks of 80 over 4 slots of 20: the tile drops to
    4 shots, another tile stream than the unmeshed run's 16, so only the
    counts' consistency is checked (as the JAX package's own test does)."""
    c = get_code("shor")
    cfg = SimConfig(shots=200, dec_type="MS", dec_iterations=10, rng_seed=23,
                    batch_size=80, mesh=_cpu_mesh(4))
    pipe = ShotPipeline(c.Hx, c.Hz, cfg)
    assert (pipe.per_dev, pipe.tile, pipe.tiles_per_dev) == (20, 4, 5)
    r = simulate_p(c.Hx, c.Hz, 0.02, cfg, pipeline=pipe)
    assert len(r.counters) == 7 and r.shots == 200
    assert r.counters["decSuccessExact"] + r.counters["decSuccessDegen"] <= 200
    assert r.counters["successStabilizer"] <= 200
    assert 1.0 <= r.avg_iterations_x <= 10.0


@pytest.mark.parametrize("osd_order", [-1, 2])
def test_a_slot_with_no_valid_shot_counts_nothing(osd_order):
    """The engine skips a slot whose chunks have no valid shot; run anyway,
    the multi-chunk body (and its deferred OSD pass) counts nothing."""
    c = get_code("steane")
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(
        dec_type="MS", dec_iterations=8, dec_schedule="L", osd_order=osd_order,
        batch_size=128, device="cpu"))
    keys = montecarlo.chunk_keys(montecarlo.prng_key(1), 0, 4).reshape(2, 2, 2)
    counts = pipe._multi_chunk_body(keys, 0.3, [0, 0])
    assert {k: int(v) for k, v in counts.items()} == {
        k: 0 for k in montecarlo._COUNTER_KEYS}
    assert pipe.osd_shots == {"x": 0, "z": 0}


def test_multihost_init_without_context_does_nothing(monkeypatch):
    for v in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert multihost_init() is False
    assert not torch.distributed.is_initialized()
    assert mesh_mod.world() == (0, 1)


def test_make_mesh(monkeypatch):
    m = make_mesh(["cpu", "cpu"])
    assert m == Mesh(devices=(torch.device("cpu"),) * 2, size=2)
    assert local_mesh_rows(m) == [(0, torch.device("cpu")),
                                  (1, torch.device("cpu"))]
    with pytest.raises(ValueError):
        make_mesh([])
    with pytest.raises(ValueError):
        make_mesh(["meta"])
    # one card named twice: a 2-slot mesh on a one-card machine
    assert make_mesh(["cuda", "cuda:0"]).devices == (torch.device("cuda", 0),) * 2
    # no devices: the cards this process sees, or one per local rank
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="sees none"):
        make_mesh()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert make_mesh().devices == tuple(torch.device("cuda", i)
                                        for i in range(4))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    monkeypatch.setenv("LOCAL_RANK", "5")
    assert make_mesh().devices == (torch.device("cuda", 1),)


def test_allreduce_alone_returns_the_counters():
    t = torch.arange(18, dtype=torch.int64).reshape(2, 9)
    assert torch.equal(allreduce_counters_host(t), t)
    with pytest.raises(ValueError):
        allreduce_counters_host(t.to(torch.int32))


def test_exec_mode(monkeypatch):
    c = get_code("steane")
    kw = dict(dec_type="MS", dec_iterations=8, batch_size=128)
    monkeypatch.delenv("QLDPC_EXEC_MODE", raising=False)
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(mesh=_cpu_mesh(2), **kw))
    assert pipe.exec_mode == "perdevice"
    with pytest.raises(ValueError, match="perdevice"):
        ShotPipeline(c.Hx, c.Hz, SimConfig(mesh=_cpu_mesh(2),
                                           exec_mode="shardmap", **kw))
    monkeypatch.setenv("QLDPC_EXEC_MODE", "shardmap")
    with pytest.raises(ValueError, match="perdevice"):
        ShotPipeline(c.Hx, c.Hz, SimConfig(mesh=_cpu_mesh(2), **kw))
    monkeypatch.setenv("QLDPC_EXEC_MODE", "perdevice")
    assert ShotPipeline(c.Hx, c.Hz, SimConfig(
        mesh=_cpu_mesh(2), **kw)).exec_mode == "perdevice"
    with pytest.raises(ValueError, match="not divisible"):
        ShotPipeline(c.Hx, c.Hz, SimConfig(mesh=_cpu_mesh(3), **kw))


def test_layout_of_the_chunk():
    assert montecarlo._auto_batch(544, 262144, 4) == 4096
    assert montecarlo._auto_batch(544, 200, 4) == 256
    assert montecarlo._auto_batch(544, 10 ** 6, 128) == 8192
    assert montecarlo._tile_size(512, 128) == 64
    assert montecarlo._tile_size(80, 20) == 4
    c = get_code("lp04_0")
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(shots=10 ** 6, dec_type="MS",
                                              mesh=_cpu_mesh(2)))
    assert (pipe.batch, pipe.per_dev, pipe.tiles_per_dev,
            pipe.tiles_per_chunk) == (4096, 2048, 32, 64)
    assert [s.batch for s in pipe.slots] == [2048, 2048]


def test_checkpoint_identity_has_the_slot_count(tmp_path):
    c = get_code("steane")
    kw = dict(shots=512, dec_type="MS", dec_iterations=8, batch_size=256,
              rng_seed=1)
    one = ShotPipeline(c.Hx, c.Hz, SimConfig(device="cpu", **kw))
    two = ShotPipeline(c.Hx, c.Hz, SimConfig(mesh=_cpu_mesh(2), **kw))
    assert montecarlo._ckpt_id(one, one.cfg, 1, 0.03, 0) != \
        montecarlo._ckpt_id(two, two.cfg, 1, 0.03, 0)


def test_meshed_run_resumes_from_its_checkpoint(tmp_path, monkeypatch):
    """A meshed run killed after its first key group resumes to the
    counters of an uninterrupted run."""
    c = get_code("steane")
    monkeypatch.setattr(montecarlo, "_KEY_GROUP_CHUNKS", 1)
    cfg = SimConfig(shots=768, dec_type="MS", dec_iterations=10, rng_seed=9,
                    batch_size=256, mesh=_cpu_mesh(2),
                    checkpoint_dir=str(tmp_path))
    whole = simulate_p(c.Hx, c.Hz, 0.04, dataclasses.replace(
        cfg, checkpoint_dir=None))
    real_save = CheckpointStore.save

    def save_then_die(self, run_id, counters, chunks_done):
        real_save(self, run_id, counters, chunks_done)
        raise KeyboardInterrupt

    monkeypatch.setattr(CheckpointStore, "save", save_then_die)
    with pytest.raises(KeyboardInterrupt):
        simulate_p(c.Hx, c.Hz, 0.04, cfg)
    monkeypatch.setattr(CheckpointStore, "save", real_save)
    (saved,) = tmp_path.glob("*.json")
    assert json.loads(saved.read_text())["chunks_done"] == 1
    assert _counters(simulate_p(c.Hx, c.Hz, 0.04, cfg)) == _counters(whole)


def test_only_rank_0_writes_a_checkpoint(tmp_path, monkeypatch):
    store = CheckpointStore(str(tmp_path))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    store.save("run", {"a": 1}, 3)
    assert list(tmp_path.iterdir()) == []
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 0)
    store.save("run", {"a": 1}, 3)
    assert store.load("run") == ({"a": 1}, 3)


@pytest.mark.parametrize("rank,rank0_fails", [(0, False), (1, False),
                                              (0, True), (1, True)])
def test_rank_0_builds_while_the_others_wait(monkeypatch, rank, rank0_fails):
    """Under a process group `load_all` runs nvcc on rank 0 only; the other
    ranks learn its outcome from one broadcast and then load."""
    built, loaded, sent = [], [], []

    def build_many(names):
        built.append(tuple(names))
        if rank0_fails:
            raise RuntimeError("nvcc failed")

    def broadcast(t, src):
        assert src == 0
        if rank == 0:
            sent.append(int(t))
        else:
            t.fill_(0 if rank0_fails else 1)

    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: rank)
    monkeypatch.setattr(dist, "broadcast", broadcast)
    monkeypatch.setattr(_build, "_build_many", build_many)
    monkeypatch.setattr(_build, "load", loaded.append)
    if rank0_fails:
        with pytest.raises(RuntimeError):
            _build.load_all(("channel", "ms_qc"))
    else:
        _build.load_all(("channel", "ms_qc"))
    assert built == ([("channel", "ms_qc")] if rank == 0 else [])
    assert sent == ([0 if rank0_fails else 1] if rank == 0 else [])
    assert loaded == ([] if rank0_fails else ["channel", "ms_qc"])


def test_a_launch_on_a_card_that_is_not_current_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    _build.require_current(torch.device("cuda", 0))
    with pytest.raises(RuntimeError, match="current device"):
        _build.require_current(torch.device("cuda", 1))


def test_every_launch_wrapper_checks_the_current_device_first():
    """Each of the six wrappers checks its tensors' card before it asks for
    the stream and launches (the C side launches on the calling thread's
    current device)."""
    from qldpcsim_torch.ops import (channel_cuda, flood_qc_cuda,
                                    general_h_cuda, gf2_elim_cuda, ms_qc_cuda,
                                    seq_qc_cuda)

    for fn in (channel_cuda._launch, ms_qc_cuda.ms_qc_cuda,
               flood_qc_cuda.flood_qc_cuda, general_h_cuda.general_h_cuda,
               gf2_elim_cuda.eliminate_cuda, seq_qc_cuda.seq_qc_cuda):
        src = inspect.getsource(fn)
        i = src.index("_build.require_current(dev)")
        assert i < src.index("stream =") and i < src.index("rc = fn("), fn


_CHILD = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from qldpcsim_torch.parallel.mesh import make_mesh, multihost_init, world
    rank = int(sys.argv[1])
    assert multihost_init(init_method=sys.argv[2], world_size=2, rank=rank,
                          timeout_s=60)
    assert multihost_init() and world() == (rank, 2)
    mesh = make_mesh(["cpu"] * (rank + 1))   # 1 + 2 slots
    assert (mesh.size, mesh.first) == (3, rank)
    from qldpcsim_torch.codes import get_code
    from qldpcsim_torch.engine.montecarlo import (SimConfig, simulate_p,
                                                  simulate_sweep)
    c = get_code("steane")
    kw = dict(dec_type="MS", dec_iterations=10, rng_seed=3, device="cpu")
    r = simulate_p(c.Hx, c.Hz, 0.03, SimConfig(shots=700, batch_size=192,
                                               mesh=mesh, **kw))
    sweep = simulate_sweep(c.Hx, c.Hz, [0.03, 0.06, 0.09], SimConfig(
        shots=256, batch_size=128, mesh_p=3, mesh=mesh, **kw))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "qldpcsim_tpu"))
    with open(sys.argv[3] + str(rank), "w") as f:
        json.dump({"single": r.counters, "sweep": [s.counters for s in sweep],
                   "bad": bad}, f)
""")


def _run_two(args_of, tmp_path, env=None, timeout=180):
    procs = [subprocess.Popen(
        [sys.executable, *args_of(rank)], cwd=REPO, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                 **(env(rank) if env else {})))
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-3000:]
                                                     for o in outs]
    return outs


def test_two_processes_over_gloo_equal_one(tmp_path):
    """Two processes (one and two CPU slots) in one gloo group: `simulate_p`
    and a 3-row `simulate_sweep` give every rank the counters of a
    single-process run; the children import nothing of jax."""
    out = str(tmp_path / "counters")
    init = f"file://{tmp_path / 'rendezvous'}"
    _run_two(lambda rank: ["-c", _CHILD, str(rank), init, out], tmp_path)
    c0, c1 = (json.load(open(out + str(rank))) for rank in range(2))
    assert c0 == c1 and c0["bad"] == []
    c = get_code("steane")
    kw = dict(dec_type="MS", dec_iterations=10, rng_seed=3, device="cpu")
    assert c0["single"] == simulate_p(c.Hx, c.Hz, 0.03, SimConfig(
        shots=700, batch_size=192, **kw)).counters
    assert c0["sweep"] == [simulate_p(c.Hx, c.Hz, p, SimConfig(
        shots=256, batch_size=128, **kw), p_index=i).counters
        for i, p in enumerate([0.03, 0.06, 0.09])]


def test_a_peer_that_never_comes_raises(tmp_path):
    script = textwrap.dedent(f"""
        from qldpcsim_torch.parallel.mesh import multihost_init
        try:
            multihost_init(init_method="file://{tmp_path / 'rdv'}",
                           world_size=2, rank=0, timeout_s=2)
        except RuntimeError as exc:
            print("raised", exc)
    """)
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, text=True,
                       capture_output=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.startswith("raised")
