"""`portbench/program_idle.py` on synthetic traces: each idle gap of the
device goes to the innermost program span under its middle, on any thread,
or to `outside`; the layers of the span names; the parts of an idle share
add up to it."""

import pytest

from portbench import program_idle


def ev(name, cat, ts, dur, tid=1):
    return {"name": name, "cat": cat, "ts": float(ts), "dur": float(dur),
            "tid": tid}


def kernel(ts, dur):
    return ev("k", "kernel", ts, dur, tid=7)


def span(name, ts, dur, tid=1):
    return ev(name, "user_annotation", ts, dur, tid)


def test_gaps_go_to_the_innermost_span_on_any_thread():
    events = [
        kernel(0, 10), kernel(20, 10), kernel(50, 10), kernel(100, 10),
        kernel(130, 10), kernel(160, 1),
        # main thread: the job around everything, a chunk over 0-70
        span("qldpc.job", -5, 200), span("qldpc.chunk", 0, 70),
        # the chunk's decode on the main thread covers the first gap
        span("qldpc.decode.x", 12, 6),
        # a slot thread's classify covers the second gap's middle (40)
        span("qldpc.classify", 31, 18, tid=2),
        # a benchmark range and an operator are no program span
        span("portbench.decode_x", 60, 40), ev("aten::add", "cpu_op", 61, 38),
        # the fourth gap (110-130) lies under the job alone
        # the fifth (140-160) under a slot thread's OSD compaction
        span("qldpc.osd.compact", 140, 20, tid=2),
    ]
    got = program_idle.gap_spans(events)
    assert got == [(pytest.approx(10e-6), "qldpc.decode.x"),
                   (pytest.approx(20e-6), "qldpc.classify"),
                   (pytest.approx(40e-6), "qldpc.job"),
                   (pytest.approx(20e-6), "qldpc.job"),
                   (pytest.approx(20e-6), "qldpc.osd.compact")]
    by = program_idle.idle_by_layer(events)
    assert by == {"decode": pytest.approx(10e-6),
                  "classify": pytest.approx(20e-6),
                  "osd": pytest.approx(20e-6), "channel": 0.0,
                  "driver": pytest.approx(60e-6), "outside": 0.0}


def test_gaps_under_no_program_span_are_outside():
    events = [kernel(0, 10), kernel(30, 10), kernel(60, 10),
              span("qldpc.channel", 35, 30),
              ev("cudaLaunchKernel", "cuda_runtime", 12, 16),
              span("portbench.channel", 5, 30)]
    by = program_idle.idle_by_layer(events)
    assert by["outside"] == pytest.approx(20e-6)
    assert by["channel"] == pytest.approx(20e-6)
    assert sum(by.values()) == pytest.approx(40e-6)


def test_no_device_work_no_gap():
    assert program_idle.gap_spans([span("qldpc.job", 0, 10)]) == []
    assert set(program_idle.idle_by_layer([])) == set(program_idle.LAYERS)


@pytest.mark.parametrize("name,layer", [
    ("qldpc.decode.x", "decode"), ("qldpc.decode.z", "decode"),
    ("qldpc.cascade.head", "decode"), ("qldpc.cascade.stage", "decode"),
    ("qldpc.cascade.compact", "decode"), ("qldpc.gcascade.chunk", "decode"),
    ("qldpc.gcascade.finish", "decode"), ("qldpc.classify", "classify"),
    ("qldpc.osd", "osd"), ("qldpc.osd.compact", "osd"),
    ("qldpc.osd.defer", "osd"), ("qldpc.osd.group", "osd"),
    ("qldpc.channel", "channel"), ("qldpc.job", "driver"),
    ("qldpc.group", "driver"), ("qldpc.readback", "driver"),
    ("qldpc.chunk", "driver"), ("qldpc.mesh.slot", "driver"),
    ("qldpc.mesh.wait", "driver"), ("qldpc.mesh.allreduce", "driver")])
def test_layer_of_every_span(name, layer):
    assert program_idle.layer_of(name) == layer


def test_parts_add_up_to_the_idle_share():
    secs = {"decode": 0.0123, "classify": 0.004, "osd": 0.0, "channel":
            0.0005, "driver": 0.007, "outside": 0.0002}
    parts = program_idle.idle_parts(0.6371, secs)
    assert abs(sum(parts.values()) - 0.6371) < 1e-9
    assert parts["decode"] == pytest.approx(0.6371 * 0.0123 / 0.024)
    assert program_idle.idle_parts(0.5, dict.fromkeys(secs, 0.0)) == {}
