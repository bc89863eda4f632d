"""The port's p-sweep with the p-points as a second axis of slots
(`simulate_sweep`, `SimConfig.mesh_p`) on CPU slots: per-p counters bit for
bit with the JAX package's `simulate_sweep` and with the port's serial loop
(3 p-points over 2 p-rows, so the last block has an empty row), BP bit for
bit with the serial loop and within 4 sigma of the JAX package, checkpoint
resume after a stop, the wall/warm time split, the (1, 1) grid, and
`simulate`'s dispatch."""

import dataclasses
import math
import os

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.engine.montecarlo import SimConfig as RefSimConfig
from qldpcsim_tpu.engine.montecarlo import simulate_sweep as ref_simulate_sweep

from qldpcsim_torch.engine import montecarlo
from qldpcsim_torch.engine.montecarlo import (
    SimConfig,
    simulate,
    simulate_p,
    simulate_sweep,
)
from qldpcsim_torch.parallel.mesh import make_mesh
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


def _serial(code, ps, cfg):
    return [simulate_p(code.Hx, code.Hz, p, dataclasses.replace(
        cfg, mesh=None, mesh_p=0, device="cpu"), p_index=i)
        for i, p in enumerate(ps)]


PS = [0.02, 0.04, 0.06]  # 3 p-points over 2 p-rows: the last row is empty


@pytest.mark.parametrize("slots", [2, 4])
def test_ms_sweep_equals_the_jax_sweep_and_the_serial_loop(slots):
    """MS-F-8 on lp04_0, 1280 shots in 512-shot chunks (a partial last
    chunk): the JAX sweep runs 4 devices per p-row, the port 1 or 2 slots
    per row; every per-p counter is equal."""
    code = get_code("lp04_0")
    kw = dict(shots=1280, dec_type="MS", dec_iterations=8, rng_seed=7,
              batch_size=512, mesh_p=2)
    ref = ref_simulate_sweep(code.Hx, code.Hz, PS, RefSimConfig(**kw))
    cfg = SimConfig(mesh=make_mesh(["cpu"] * slots), **kw)
    swept = simulate_sweep(code.Hx, code.Hz, PS, cfg)
    serial = _serial(code, PS, cfg)
    assert [r.p for r in swept] == PS
    for a, b, c in zip(swept, ref, serial):
        assert _counters(a) == _counters(b) == _counters(c), a.p
    assert swept[0].counters != swept[2].counters


def test_bp_osd_sweep_equals_the_serial_loop_and_is_within_4_sigma_of_jax():
    code = get_code("lp04_0")
    shots = 1280
    kw = dict(shots=shots, dec_type="BP", dec_iterations=8, rng_seed=7,
              osd_order=1, batch_size=512, mesh_p=2)
    cfg = SimConfig(**kw, device="cpu")  # default_mesh: 2 CPU slots
    swept = simulate_sweep(code.Hx, code.Hz, PS, cfg)
    serial = _serial(code, PS, cfg)
    ref = ref_simulate_sweep(code.Hx, code.Hz, PS, RefSimConfig(**kw))
    for a, b, c in zip(swept, serial, ref):
        assert _counters(a) == _counters(b), a.p
        pool = (a.qbler + c.qbler) / 2
        sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
        assert abs(a.qbler - c.qbler) <= 4 * sigma, (a.p, a.qbler, c.qbler)


def test_sweep_resumes_after_a_stop(tmp_path, monkeypatch):
    """A sweep stopped after its first key group resumes from the
    checkpoint of its (p-block, key group) to the counters of an
    uninterrupted sweep, and a finished sweep answers from its
    checkpoints."""
    code = get_code("steane")
    monkeypatch.setattr(montecarlo, "_KEY_GROUP_CHUNKS", 1)
    base = dict(shots=768, dec_type="MS", dec_iterations=10, rng_seed=9,
                batch_size=256, mesh_p=2, device="cpu")
    full = simulate_sweep(code.Hx, code.Hz, [0.02, 0.04], SimConfig(
        checkpoint_dir=str(tmp_path / "a"), **base))
    real_save = CheckpointStore.save
    saves = []

    class Stop(Exception):
        pass

    def save_once(self, run_id, counters, chunks_done):
        real_save(self, run_id, counters, chunks_done)
        saves.append(chunks_done)
        if len(saves) == 1:
            raise Stop

    monkeypatch.setattr(CheckpointStore, "save", save_once)
    cfg = SimConfig(checkpoint_dir=str(tmp_path / "b"), **base)
    with pytest.raises(Stop):
        simulate_sweep(code.Hx, code.Hz, [0.02, 0.04], cfg)
    resumed = simulate_sweep(code.Hx, code.Hz, [0.02, 0.04], cfg)
    assert saves == [1, 2, 3]  # the resumed run started at chunk 1
    for a, b in zip(full, resumed):
        assert _counters(a) == _counters(b)
    (ckpt,) = (tmp_path / "b").glob("sweepblk0_MSF_*.json")
    monkeypatch.setattr(CheckpointStore, "save", real_save)
    monkeypatch.setattr(montecarlo.ShotPipeline, "_multi_chunk_body",
                        lambda *a: pytest.fail("decoded a counted chunk"))
    again = simulate_sweep(code.Hx, code.Hz, [0.02, 0.04], cfg)
    assert [_counters(r) for r in again] == [_counters(r) for r in full]


def test_sweep_checkpoint_identity_has_the_block_geometry(tmp_path):
    code = get_code("steane")
    base = dict(shots=256, dec_type="MS", dec_iterations=8, rng_seed=1,
                batch_size=128, device="cpu", checkpoint_dir=str(tmp_path))
    simulate_sweep(code.Hx, code.Hz, [0.01, 0.02, 0.03, 0.04],
                   SimConfig(mesh_p=2, **base))
    simulate_sweep(code.Hx, code.Hz, [0.01, 0.02, 0.03, 0.04],
                   SimConfig(mesh_p=4, **base))
    names = sorted(p.name.split("_")[0] for p in tmp_path.glob("*.json"))
    assert names == ["sweepblk0", "sweepblk0", "sweepblk2"]


def test_sweep_timing_splits_wall_time_and_keeps_warm_time():
    """A block's points run together: each point's wall time is the
    block's divided by its points, the warm time is the block's undivided
    time after its first chunk, and warm shots/s is finite."""
    code = get_code("steane")
    cfg = SimConfig(shots=512, dec_type="MS", dec_iterations=8, rng_seed=3,
                    batch_size=128, mesh_p=2, device="cpu")
    rs = simulate_sweep(code.Hx, code.Hz, [0.01, 0.02, 0.03], cfg)
    assert len(rs) == 3
    for r in rs:
        assert r.wall_time_s > 0 and r.warm_shots == 384  # chunks 2 to 4
        assert r.warm_time_s == r.warm_time_s and r.shots_per_s_warm > 0
    assert rs[0].wall_time_s == rs[1].wall_time_s
    assert rs[0].warm_time_s == rs[1].warm_time_s
    # the lone point of the second block has all of its block's time
    assert rs[2].wall_time_s > rs[2].warm_time_s


def test_one_by_one_grid_is_the_serial_loop(monkeypatch):
    code = get_code("steane")
    cfg = SimConfig(shots=256, dec_type="MS", dec_iterations=8, rng_seed=4,
                    batch_size=128, mesh_p=1, mesh=make_mesh(["cpu"]))
    monkeypatch.setattr(montecarlo, "per_device_multi_chunk_fn",
                        lambda *a, **k: pytest.fail("built a sharded run"))
    swept = simulate_sweep(code.Hx, code.Hz, [0.02, 0.05], cfg)
    serial = _serial(code, [0.02, 0.05], cfg)
    assert [_counters(r) for r in swept] == [_counters(r) for r in serial]


def test_sweep_geometry_is_checked():
    code = get_code("steane")
    with pytest.raises(ValueError, match="divide"):
        simulate_sweep(code.Hx, code.Hz, [0.01], SimConfig(
            mesh_p=2, mesh=make_mesh(["cpu"] * 3)))
    with pytest.raises(ValueError, match="mesh_p"):
        simulate_sweep(code.Hx, code.Hz, [0.01], SimConfig(mesh_p=0,
                                                           device="cpu"))
    with pytest.raises(ValueError, match="perdevice"):
        simulate_sweep(code.Hx, code.Hz, [0.01, 0.02], SimConfig(
            mesh_p=2, exec_mode="shardmap", device="cpu"))


def test_simulate_dispatches_to_the_sweep(capsys):
    files = [os.path.join(REPO, "data", f"H{s}_steane.npy") for s in "xz"]
    kw = dict(shots=256, decType="MS", decIterations=8, rngSeed=2,
              batch_size=128, device="cpu")
    swept = simulate(*files, [0.02, 0.05, 0.08], mesh_p=2, **kw)
    serial = simulate(*files, [0.02, 0.05, 0.08], **kw)
    assert capsys.readouterr().out.count("SIMULATION RESULTS") == 2
    assert [_counters(r) for r in swept] == [_counters(r) for r in serial]
