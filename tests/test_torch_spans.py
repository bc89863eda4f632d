"""The program's spans (`utils/profiling.py`) on the CPU: seeded runs count
the same with spans on and off on every path (min-sum in the cascade, BP +
OSD with the group-level pass, the group cascade, a 2-slot mesh); off takes
no record; on, every span of each path is recorded, nested as the layers
are, with its chunk's key branch and index, on the slot threads of a mesh
too; merged into a `torch.profiler` trace they sit on its clock and cover
every operator of the main thread; `--profile` writes them."""

import json
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from qldpcsim_torch import cli
from qldpcsim_torch.codes import get_code
from qldpcsim_torch.decoders.cascade import Cascade
from qldpcsim_torch.engine import group_cascade
from qldpcsim_torch.engine.montecarlo import (
    ShotPipeline,
    SimConfig,
    simulate_p,
)
from qldpcsim_torch.parallel.mesh import make_mesh
from qldpcsim_torch.utils import profiling
from qldpcsim_torch.utils.profiling import merge_spans, span, spans_on

P_INDEX = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MS30 = dict(dec_type="MS", dec_iterations=30, dec_schedule="L", rng_seed=3,
            batch_size=256)
CASCADE = {"qldpc.cascade.head", "qldpc.cascade.stage",
           "qldpc.cascade.compact", "qldpc.cascade.window"}
CHUNK = {"qldpc.job", "qldpc.group", "qldpc.readback", "qldpc.channel",
         "qldpc.classify"} | CASCADE
SIDES = {"qldpc.chunk", "qldpc.decode.x", "qldpc.decode.z"}
# (code, p, SimConfig fields, group cascade on, the spans the run records)
CASES = {
    "ms_cascade": ("steane", 0.08, dict(shots=1024, **MS30), False,
                   CHUNK | SIDES),
    "bp_osd_group": ("lp04_0", 0.08, dict(
        shots=768, dec_type="BP", dec_iterations=16, dec_schedule="F",
        osd_order=1, rng_seed=3, batch_size=256), False,
        CHUNK | SIDES | {"qldpc.osd", "qldpc.osd.compact", "qldpc.osd.defer",
                         "qldpc.osd.group"}),
    # the group cascade's head and tail are bare decoders: no stage
    "group_cascade": ("steane", 0.1, dict(shots=1024, **MS30), True,
                      CHUNK - CASCADE | {"qldpc.gcascade.chunk",
                                         "qldpc.gcascade.finish"}),
    "mesh2": ("steane", 0.08, dict(shots=1024, mesh=make_mesh(["cpu"] * 2),
                                   **MS30), False,
              CHUNK | SIDES | {"qldpc.mesh.slot", "qldpc.mesh.wait",
                               "qldpc.mesh.allreduce"}),
}


def _pipeline(monkeypatch, case):
    code, p, kw, gated, _ = CASES[case]
    c = get_code(code)
    if gated:
        monkeypatch.setenv(group_cascade.ENV, "1")
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(device="cpu", **kw))
    monkeypatch.delenv(group_cascade.ENV, raising=False)
    assert (pipe.group_cascade is not None) == gated
    return c, p, pipe


def _counts(res, pipe):
    """Every counter of a run: the result's and the pipelines' own."""
    out = dict(res.counters, avg_x=res.avg_iterations_x,
               avg_z=res.avg_iterations_z)
    for i, s in enumerate(pipe.slots if pipe.slots is not None else [pipe]):
        casc = [d for d in (s.dec_x, s.dec_z) if isinstance(d, Cascade)]
        out[f"{i}.syncs"] = [d.syncs for d in casc]
        out[f"{i}.stage_lanes"] = [list(d.stage_lanes) for d in casc]
        out[f"{i}.windows"] = [d.windows for d in casc]
        out[f"{i}.osd"] = [dict(s.osd_shots), s.osd_syncs]
        if s.group_cascade is not None:
            gc = s.group_cascade
            out[f"{i}.gc"] = [gc.deferred, gc.syncs, dict(gc.tail_lanes)]
    return out


def _run(c, p, pipe):
    return simulate_p(c.Hx, c.Hz, p, pipe.cfg, pipeline=pipe,
                      p_index=P_INDEX)


@pytest.fixture(scope="module")
def runs():
    """Each case run twice on one pipeline, spans off then on: the counters
    after each, the records of the second and the appends of the first."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for case in CASES:
            c, p, pipe = _pipeline(mp, case)
            appended = []
            mp.setattr(profiling, "_append", appended.append)
            off = _counts(_run(c, p, pipe), pipe)
            mp.undo()
            with spans_on() as records:
                on = _counts(_run(c, p, pipe), pipe)
            out[case] = (off, on, records, appended, pipe)
    finally:
        mp.undo()
    return out


def _sub(x, y):
    if isinstance(x, dict):
        return {k: _sub(x[k], y[k]) for k in x}
    if isinstance(x, list):
        return [_sub(u, v) for u, v in zip(x, y)]
    return x - y


@pytest.mark.parametrize("case", list(CASES))
def test_spans_change_no_counter(runs, case):
    """The run with spans counts what the run without them counted: the
    result's counters and iterations, and what the pipeline's own counters
    (which add up over runs, from a fresh pipeline's zero) gained."""
    off, on, records, appended, _ = runs[case]
    assert appended == []          # off: nothing recorded
    assert records                 # on: the same run recorded
    assert {k: (v if "." not in k else _sub(v, off[k]))
            for k, v in on.items()} == off


@pytest.mark.parametrize("case", list(CASES))
def test_every_span_of_the_path_is_recorded(runs, case):
    records = runs[case][2]
    assert {r.name for r in records} == CASES[case][4]
    assert all(r.end_ns is not None and r.end_ns >= r.start_ns
               for r in records)


def _chain(r):
    names = []
    while r is not None:
        names.append(r.name)
        r = r.parent
    return names


def test_spans_nest_as_the_layers(runs):
    """compact in a stage of side X's decode, in its chunk, in its key
    group, in the job; every chunk has the job's key branch and its
    index."""
    records = runs["ms_cascade"][2]
    compact = [r for r in records if r.name == "qldpc.cascade.compact"]
    x = [r for r in compact if "qldpc.decode.x" in _chain(r)]
    assert x and all(_chain(r) == [
        "qldpc.cascade.compact", "qldpc.cascade.stage", "qldpc.decode.x",
        "qldpc.chunk", "qldpc.group", "qldpc.job"] for r in x)
    assert {r.args["level"] for r in records
            if r.name == "qldpc.cascade.stage"} == {1, 2}
    chunks = [r for r in records if r.name == "qldpc.chunk"]
    assert [r.args for r in chunks] == [{"p_index": P_INDEX, "chunk": i}
                                        for i in range(4)]
    assert [r.args for r in records if r.name == "qldpc.job"] == [
        {"p_index": P_INDEX}]
    for r in records:     # a child lies within its parent
        if r.parent is not None:
            assert r.parent.start_ns <= r.start_ns <= r.end_ns \
                <= r.parent.end_ns


def test_a_window_span_per_refinement_window(runs):
    """Each refinement window of the staged cascade is one
    `qldpc.cascade.window` inside its `qldpc.cascade.stage`, with its lanes:
    as many as `Cascade.windows` counted, their lanes the lanes the
    refinement stages decoded."""
    off, on, records, _, _ = runs["ms_cascade"]
    windows = [r for r in records if r.name == "qldpc.cascade.window"]
    assert windows
    assert all(r.parent.name == "qldpc.cascade.stage" for r in windows)
    assert all(1 <= r.args["lanes"] <= 64 for r in windows)
    assert len(windows) == sum(_sub(on["0.windows"], off["0.windows"]))
    assert sum(r.args["lanes"] for r in windows) == sum(
        sum(lanes[1:]) for lanes in _sub(on["0.stage_lanes"],
                                         off["0.stage_lanes"]))


def test_mesh_slot_threads_carry_their_chunks(runs):
    records = runs["mesh2"][2]
    main = {r.tid for r in records if r.name == "qldpc.job"}
    slots = [r for r in records if r.name == "qldpc.mesh.slot"]
    assert len({r.tid for r in slots}) == 2 and not main & {
        r.tid for r in slots}
    assert all(r.parent is None for r in slots)   # a root on its thread
    chunks = [r for r in records if r.name == "qldpc.chunk"]
    assert len(chunks) == 8     # 4 chunks, each on both slots
    for r in chunks:
        assert _chain(r)[1:] == ["qldpc.mesh.slot"]
        assert r.args["p_index"] == P_INDEX
    # each slot runs chunks 0..3, the first alone, then a key group
    for tid in {r.tid for r in slots}:
        assert sorted(r.args["chunk"] for r in chunks
                      if r.tid == tid) == [0, 1, 2, 3]
    for name in ("qldpc.mesh.wait", "qldpc.mesh.allreduce"):
        assert {r.tid for r in records if r.name == name} == main


def test_span_off_is_the_shared_no_op():
    assert span("qldpc.probe") is span("qldpc.chunk", p_index=1, chunk=2)
    with span("qldpc.probe") as got:
        assert got is None
    with spans_on() as records:
        with span("qldpc.probe", k=1) as rec:
            assert rec is records[0]
        with spans_on() as inner:            # a scope of its own
            with span("qldpc.inner"):
                pass
        with span("qldpc.after"):
            pass
    assert [r.name for r in records] == ["qldpc.probe", "qldpc.after"]
    assert [r.name for r in inner] == ["qldpc.inner"]
    assert span("qldpc.probe") is span("qldpc.other")   # off again


def _trace(tmp_path, body):
    """A CPU trace of `body()` with the spans merged -> its events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            spans_on() as records:
        body()
    path = str(tmp_path / "t.trace.json")
    prof.export_chrome_trace(path)
    assert merge_spans(path, records) == len(records)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_merged_spans_sit_on_the_trace_clock(tmp_path):
    """Each merged span encloses the profiler's own range opened inside
    it (to the 50 µs the two clocks' readings may differ by), and starts
    and ends within 1 ms of it: the median of 9 probes, since a thread
    may be preempted between the two."""
    def body():
        x = torch.ones(64)
        with record_function("warm"):     # the profiler's first range
            x = x + 1
        for _ in range(9):
            with span("qldpc.probe"):
                with record_function("probe.range"):
                    x = x * 2 + 1

    events = _trace(tmp_path, body)
    mine = sorted((e for e in events if e["name"] == "qldpc.probe"),
                  key=lambda e: e["ts"])
    theirs = sorted((e for e in events if e["name"] == "probe.range"),
                    key=lambda e: e["ts"])
    assert len(mine) == len(theirs) == 9
    lead, lag = [], []
    for m, t in zip(mine, theirs):
        assert m["cat"] == "user_annotation" and m["pid"] == os.getpid()
        assert m["tid"] == t["tid"] and m["args"] == {}
        lead.append(t["ts"] - m["ts"])
        lag.append(m["ts"] + m["dur"] - t["ts"] - t["dur"])
    assert min(lead) >= -50 and min(lag) >= -50
    assert sorted(lead)[4] <= 1000 and sorted(lag)[4] <= 1000


def test_every_main_thread_operator_lies_under_a_span(tmp_path):
    c = get_code("steane")
    pipe = ShotPipeline(c.Hx, c.Hz, SimConfig(device="cpu", shots=512,
                                              **MS30))
    events = _trace(tmp_path, lambda: _run(c, 0.08, pipe))
    spans = [e for e in events if e["name"].startswith("qldpc.")]
    main = next(e["tid"] for e in spans if e["name"] == "qldpc.job")
    ops = [e for e in events if e["name"].startswith("aten::")
           and e["tid"] == main]
    assert ops
    for op in ops:
        assert any(s["tid"] == main and s["ts"] - 500 <= op["ts"]
                   and op["ts"] + op["dur"] <= s["ts"] + s["dur"] + 500
                   for s in spans), op["name"]


def test_merge_skips_open_spans_and_keeps_the_base(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": 1_000_000_000,
                                "traceEvents": []}))
    closed = profiling.SpanRecord("qldpc.job", {"p_index": 2})
    closed.tid, closed.start_ns = 7, 1_000_003_000
    closed.end_ns = 1_000_005_500
    opened = profiling.SpanRecord("qldpc.chunk", {})
    opened.tid, opened.parent, opened.start_ns = 7, closed, 1_000_004_000
    assert merge_spans(str(path), [closed, opened]) == 1
    (e,) = json.loads(path.read_text())["traceEvents"]
    assert e == {"ph": "X", "cat": "user_annotation", "name": "qldpc.job",
                 "pid": os.getpid(), "tid": 7, "ts": 3.0, "dur": 2.5,
                 "args": {"p_index": 2}}


def test_profile_flag_writes_the_spans(tmp_path, capsys):
    assert cli.main(["--code", "steane", "--p", "0.05", "--shots", "512",
                     "--decType", "MS", "--decIterations", "30",
                     "--rngSeed", "1", "--quiet", "--device", "cpu",
                     "--profile", str(tmp_path)]) == 0
    with open(tmp_path / "p_sweep.trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"p_sweep", "qldpc.job", "qldpc.chunk", "qldpc.decode.x",
            "qldpc.cascade.stage", "qldpc.classify"} <= names


def test_threads_keep_their_own_nesting():
    """Sixteen threads opening spans under a short switch interval: every
    span is recorded once, each under its own thread's enclosing span."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for i in range(200):
            with span("qldpc.outer", i=i):
                with span("qldpc.inner"):
                    pass

    try:
        with spans_on() as records:
            threads = [threading.Thread(target=work) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(records) == 16 * 200 * 2
    assert len({r.tid for r in records}) == 16
    for r in records:
        if r.name == "qldpc.inner":
            assert r.parent.name == "qldpc.outer" and r.parent.tid == r.tid
        else:
            assert r.parent is None
