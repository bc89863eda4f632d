"""The group-deferred cascade of the port (`engine/group_cascade.py`,
`QLDPC_GROUP_CASCADE=1`) on the CPU: the same counters and average
iterations as the in-chunk cascade, bit for bit, for min-sum (also equal to
the JAX package's `simulate_p`), for BP + OSD-1 (qBLER within 4 sigma of the
JAX package's run), under a forced overflow of the deferral capacity, with a
partial last chunk, on a 2-slot CPU mesh, in a `mesh_p` sweep and under the
serial schedule; and the gate."""

import dataclasses
import math

import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.engine.montecarlo import SimConfig as RefSimConfig
from qldpcsim_tpu.engine.montecarlo import simulate_p as ref_simulate_p

from qldpcsim_torch.decoders import DecoderConfig
from qldpcsim_torch.decoders.cascade import Cascade
from qldpcsim_torch.engine import group_cascade, montecarlo
from qldpcsim_torch.engine.montecarlo import (
    ShotPipeline,
    SimConfig,
    simulate_p,
    simulate_sweep,
)
from qldpcsim_torch.parallel.mesh import make_mesh
from qldpcsim_torch.parallel.keys import chunk_keys
from qldpcsim_torch.utils.threefry import fold_in, prng_key

GATE = group_cascade.ENV


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


def _run(monkeypatch, code, p, cfg, gated, **kw):
    """simulate_p with the gate set or unset when the pipeline is built;
    returns (result, pipeline)."""
    if gated:
        monkeypatch.setenv(GATE, "1")
    else:
        monkeypatch.delenv(GATE, raising=False)
    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    monkeypatch.delenv(GATE, raising=False)
    return simulate_p(code.Hx, code.Hz, p, cfg, pipeline=pipe, **kw), pipe


MS50 = dict(shots=2048, dec_type="MS", dec_iterations=50, rng_seed=13,
            batch_size=512)


@pytest.fixture(scope="module")
def ms50_in_chunk(lp04):
    """The in-chunk cascade's MS-50 run at p = 0.06 (no gate)."""
    return _counters(simulate_p(lp04.Hx, lp04.Hz, 0.06,
                                SimConfig(device="cpu", **MS50)))


@pytest.fixture(scope="module")
def ms50_jax(lp04):
    """The JAX package's MS-50 run at p = 0.06 (no gate)."""
    return _counters(ref_simulate_p(lp04.Hx, lp04.Hz, 0.06,
                                    RefSimConfig(dispatch_chunks=4, **MS50)))


@pytest.mark.parametrize("pending_max", [montecarlo._OSD_PENDING_MAX, 100])
def test_min_sum_equals_in_chunk_and_jax(monkeypatch, lp04, pending_max,
                                        ms50_in_chunk, ms50_jax):
    """MS-50 on lp04_0 (the twin of the JAX package's
    test_group_cascade_bit_exact): counters and average iterations of the
    group cascade equal the in-chunk cascade's and the JAX package's, also
    when the finish runs every 100 pending records."""
    monkeypatch.setattr(montecarlo, "_OSD_PENDING_MAX", pending_max)
    cfg = SimConfig(device="cpu", **MS50)
    new, pipe = _run(monkeypatch, lp04, 0.06, cfg, True)
    gc = pipe.group_cascade
    assert gc is not None and gc.gc_overflows == 0
    assert gc.deferred > 0 and gc.tail_lanes["x"] > 0
    assert not isinstance(gc.head_x, Cascade)
    assert gc.head_x.max_iter == gc.head_z.max_iter == 10
    assert gc.syncs >= MS50["shots"] // MS50["batch_size"]
    if pending_max == 100:
        assert gc.tail_windows["x"] >= 2
    assert _counters(new) == ms50_in_chunk == ms50_jax


def test_bp_osd_equals_in_chunk(monkeypatch, lp04):
    """BP-16 + OSD-1 (the twin of test_group_cascade_with_osd_bit_exact):
    the port's counters bit for bit with and without the gate, OSD on the
    tail windows' unconverged shots; qBLER within 4 sigma of the JAX
    package's (BP rounds differently there)."""
    base = dict(shots=1024, dec_type="BP", dec_iterations=16, rng_seed=5,
                batch_size=512, osd_order=1)
    cfg = SimConfig(device="cpu", **base)
    new, pipe = _run(monkeypatch, lp04, 0.07, cfg, True)
    old, _ = _run(monkeypatch, lp04, 0.07, cfg, False)
    gc = pipe.group_cascade
    # BP-16's head is the plain 4-iteration decoder, its tail the plain 16
    assert gc.head_x.max_iter == 4 and gc.tail_x.max_iter == 16
    assert gc.deferred > 0 and sum(pipe.osd_shots.values()) > 0
    assert _counters(new) == _counters(old)
    ref = ref_simulate_p(lp04.Hx, lp04.Hz, 0.07,
                         RefSimConfig(dispatch_chunks=2, **base))
    pool = (new.qbler + ref.qbler) / 2
    sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / base["shots"])
    assert abs(new.qbler - ref.qbler) <= 4 * sigma


def test_overflow_finishes_in_the_chunk(monkeypatch, lp04):
    """p = 0.30 with one 2048-shot chunk (the twin of
    test_group_cascade_overflow_fallback): more stragglers than the 512-
    record cap, so the chunk finishes them itself; counters unchanged."""
    cfg = SimConfig(shots=2048, dec_type="MS", dec_iterations=16,
                    rng_seed=7, batch_size=2048, device="cpu")
    new, pipe = _run(monkeypatch, lp04, 0.30, cfg, True)
    old, _ = _run(monkeypatch, lp04, 0.30, cfg, False)
    gc = pipe.group_cascade
    assert gc.defer_cap == 512 and gc.gc_overflows > 0
    assert gc.deferred == 0 and gc.tail_lanes["x"] > gc.defer_cap
    assert _counters(new) == _counters(old)


def test_partial_last_chunk_and_padding(monkeypatch, lp04):
    """1500 shots in 512-shot chunks: the last chunk's 36 padding lanes
    defer nothing; a chunk with no valid shot counts nothing."""
    cfg = SimConfig(device="cpu", **dict(MS50, shots=1500))
    new, pipe = _run(monkeypatch, lp04, 0.06, cfg, True)
    old, _ = _run(monkeypatch, lp04, 0.06, cfg, False)
    assert _counters(new) == _counters(old)
    key = fold_in(prng_key(13), 0)
    counts, rec = pipe.group_cascade.chunk(
        chunk_keys(key, 0, pipe.tiles_per_chunk), 0.06, 0)
    assert rec is None and all(int(v) == 0 for v in counts.values())
    counts, rec = pipe.group_cascade.chunk(
        chunk_keys(key, 0, pipe.tiles_per_chunk), 0.06, 5)
    n_rec = 0 if rec is None else rec["cx"].shape[0]
    assert n_rec <= 5
    assert int(counts["decSuccessExact"]) + n_rec <= 5


def test_two_slot_mesh_equals_the_unmeshed_run(monkeypatch, lp04,
                                               ms50_in_chunk):
    """A 2-slot CPU mesh: each slot's pipeline reads the gate and runs the
    group cascade; counters equal the unmeshed in-chunk run's."""
    cfg = SimConfig(device="cpu", **MS50)
    meshed = dataclasses.replace(cfg, mesh=make_mesh(["cpu"] * 2))
    new, pipe = _run(monkeypatch, lp04, 0.06, meshed, True)
    assert pipe.group_cascade is None
    assert all(s.group_cascade is not None for s in pipe.slots)
    assert sum(s.group_cascade.deferred for s in pipe.slots) > 0
    assert _counters(new) == ms50_in_chunk


def test_mesh_p_sweep_equals_the_serial_sweep(monkeypatch, lp04):
    """simulate_sweep with mesh_p = 2 over 2 CPU slots under the gate: each
    slot's pipeline runs the group cascade and defers stragglers, and the
    per-p counters are the serial in-chunk sweep's."""
    ps = [0.04, 0.06]
    base = dict(MS50, shots=512)
    cfg = SimConfig(device="cpu", **base)
    serial = [simulate_p(lp04.Hx, lp04.Hz, p, cfg, p_index=i)
              for i, p in enumerate(ps)]
    built = []
    plain_init = group_cascade.GroupCascade.__init__

    def recording_init(self, pipe):
        plain_init(self, pipe)
        built.append(self)

    monkeypatch.setattr(group_cascade.GroupCascade, "__init__",
                        recording_init)
    monkeypatch.setenv(GATE, "1")
    swept = simulate_sweep(lp04.Hx, lp04.Hz, ps, dataclasses.replace(
        cfg, mesh=make_mesh(["cpu"] * 2), mesh_p=2))
    assert len({id(gc.pipe) for gc in built}) == len(built) == 2
    assert all(gc.pipe.per_dev == base["batch_size"] for gc in built)
    assert all(not isinstance(gc.head_x, Cascade)
               and gc.head_x.max_iter == 10 for gc in built)
    assert sum(gc.deferred for gc in built) > 0
    assert [_counters(r) for r in swept] == [_counters(r) for r in serial]


def test_serial_schedule(monkeypatch, lp04):
    """MS-S-26 on lp04_0 at p = 0.12: the in-chunk cascade's high-p guard
    fires, the group cascade's two-stage head has none; counters and
    iterations equal all the same."""
    cfg = SimConfig(shots=256, dec_type="MS", dec_iterations=26,
                    dec_schedule="S", rng_seed=3, batch_size=256,
                    device="cpu")
    new, pipe = _run(monkeypatch, lp04, 0.12, cfg, True)
    old, plain = _run(monkeypatch, lp04, 0.12, cfg, False)
    assert plain.dec_x.highp_guard and plain.dec_x.guard_fired > 0
    assert not isinstance(pipe.group_cascade.head_x, Cascade)
    assert pipe.group_cascade.deferred + pipe.group_cascade.gc_overflows > 0
    assert _counters(new) == _counters(old)


@pytest.mark.parametrize("dec_type,max_iter,env,want", [
    ("MS", 50, "1", True),
    ("BP", 16, "1", True),
    ("MS", 13, "1", True),
    ("BF", 50, "1", False),
    ("NG", 50, "1", False),
    ("MS", 12, "1", False),
    ("BP", 10, "1", False),
    ("MS", 50, None, False),
    ("MS", 50, "0", False),
])
def test_gate(monkeypatch, lp04, dec_type, max_iter, env, want):
    """On for MS and BP above 12 iterations with QLDPC_GROUP_CASCADE=1
    only; a pipeline built under it holds the group cascade."""
    if env is None:
        monkeypatch.delenv(GATE, raising=False)
    else:
        monkeypatch.setenv(GATE, env)
    dcfg = DecoderConfig(dec_type=dec_type, max_iter=max_iter)
    assert group_cascade.enabled(dcfg) is want
    pipe = ShotPipeline(lp04.Hx, lp04.Hz, SimConfig(
        shots=64, dec_type=dec_type, dec_iterations=max_iter, device="cpu"))
    assert (pipe.group_cascade is not None) is want


@pytest.mark.parametrize("dec_type,max_iter,schedule,split", [
    ("MS", 50, "L", 2),
    ("MS", 26, "S", 2),
    ("MS", 20, "L", 1),
    ("BP", 16, "F", 1),
    ("BP", 99, "F", 2),
])
def test_head_and_tail_are_the_pipelines_stage_decoders(
        monkeypatch, lp04, dec_type, max_iter, schedule, split):
    """The head and tail of each side are bare decoders of the kernel the
    pipeline's cascade stages use, the head at the cap of its stage
    `split` (the cascade's last but one), the tail at full depth; neither
    is a stage decoder of the pipeline's own, nor a cascade."""
    monkeypatch.setenv(GATE, "1")
    pipe = ShotPipeline(lp04.Hx, lp04.Hz, SimConfig(
        shots=64, dec_type=dec_type, dec_iterations=max_iter,
        dec_schedule=schedule, device="cpu"))
    gc = pipe.group_cascade
    for casc, head, tail in ((pipe.dec_x, gc.head_x, gc.tail_x),
                             (pipe.dec_z, gc.head_z, gc.tail_z)):
        assert len(casc.stages) == split + 1
        assert type(head) is type(tail) is type(casc.decs[0])
        assert head.max_iter == casc.stages[split - 1][0]
        assert tail.max_iter == max_iter
        assert all(d is not head and d is not tail for d in casc.decs)


@pytest.mark.parametrize("p", [0.02, 0.08, 0.14])
def test_min_sum_over_p(monkeypatch, lp04, p):
    """MS-F-26 on lp04_0 from few stragglers to many, the last chunk
    partial: the group cascade's counters and iterations equal the in-chunk
    cascade's at every p, and its head decodes every lane of both chunks."""
    cfg = SimConfig(shots=384, dec_type="MS", dec_iterations=26,
                    rng_seed=17, batch_size=256, device="cpu")
    new, pipe = _run(monkeypatch, lp04, p, cfg, True)
    old, _ = _run(monkeypatch, lp04, p, cfg, False)
    gc = pipe.group_cascade
    assert not isinstance(gc.head_x, Cascade) and gc.head_x.max_iter == 10
    assert gc.deferred + gc.gc_overflows > 0
    assert _counters(new) == _counters(old)


def test_records_take_the_straggler_rows(lp04):
    """A record holds each straggler's rows of both errors, both syndromes
    (as uint8), both head estimates and both converged flags."""
    from qldpcsim_torch.decoders.common import DecodeResult

    g = torch.Generator().manual_seed(0)
    B, n, m = 16, 20, 12
    err_x, err_z, ex, ez = (torch.randint(0, 2, (B, n), generator=g,
                                          dtype=torch.uint8)
                            for _ in range(4))
    sy_z, sy_x = (torch.randint(0, 2, (B, m), generator=g).float()
                  for _ in range(2))
    cx, cz = (torch.rand(B, generator=g) < 0.5 for _ in range(2))
    res_x = DecodeResult(e_hat=ex, n_iter=torch.zeros(B), converged=cx,
                         posterior=torch.zeros(B, n))
    res_z = DecodeResult(e_hat=ez, n_iter=torch.zeros(B), converged=cz,
                         posterior=torch.zeros(B, n))
    idx = torch.tensor([1, 4, 5, 11])
    rec = group_cascade.GroupCascade._records(idx, err_x, err_z, sy_z, sy_x,
                                              res_x, res_z)
    assert rec["sy_z"].dtype == rec["sy_x"].dtype == torch.uint8
    want = {"err_x": err_x, "err_z": err_z, "sy_z": sy_z, "sy_x": sy_x,
            "ex": ex, "ez": ez, "cx": cx, "cz": cz}
    for k, v in want.items():
        assert torch.equal(rec[k].to(v.dtype), v[idx])
