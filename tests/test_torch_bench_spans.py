"""The layer pass's spans (`qldpcsim_torch/utils/bench.py::_Spans`) on the
CPU: which methods they wrap with and without `QLDPC_GROUP_CASCADE=1`, and,
with the card's events replaced by a counting clock, that a gated run goes
through the head and tail decoders and the finish, each span counting its
own time only."""

import itertools

import pytest
import torch

from qldpcsim_tpu.codes import get_code

from qldpcsim_torch.engine import group_cascade
from qldpcsim_torch.engine.montecarlo import ShotPipeline, SimConfig, simulate_p
from qldpcsim_torch.utils import bench


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


CFG = SimConfig(shots=1024, dec_type="MS", dec_iterations=50, osd_order=1,
                rng_seed=3, batch_size=512, device="cpu")


def _pipeline(monkeypatch, code, gated, cfg=CFG):
    if gated:
        monkeypatch.setenv(group_cascade.ENV, "1")
    else:
        monkeypatch.delenv(group_cascade.ENV, raising=False)
    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    monkeypatch.delenv(group_cascade.ENV, raising=False)
    return pipe


def _named(targets):
    return [(id(obj), attr, name) for obj, attr, name in targets]


def test_targets_without_the_gate(monkeypatch, lp04):
    pipe = _pipeline(monkeypatch, lp04, gated=False)
    assert pipe.group_cascade is None
    spans = bench._Spans(pipe, on_card=False)
    assert _named(spans.targets()) == _named([
        (pipe, "_sample_chunk", "channel"), (pipe, "classify", "classify"),
        (pipe, "_apply_osd", "osd"), (pipe.dec_x, "forward", "decode_x"),
        (pipe.dec_z, "forward", "decode_z")])


def test_targets_under_the_gate(monkeypatch, lp04):
    """The head and tail decoders of both sides and the finish, and not
    the pipeline's own cascades, which the group cascade never calls."""
    pipe = _pipeline(monkeypatch, lp04, gated=True)
    gc = pipe.group_cascade
    assert gc is not None
    targets = bench._Spans(pipe, on_card=False).targets()
    assert _named(targets) == _named([
        (pipe, "_sample_chunk", "channel"), (pipe, "classify", "classify"),
        (pipe, "_apply_osd", "osd"), (gc.head_x, "forward", "decode_x"),
        (gc.tail_x, "forward", "decode_x"), (gc.head_z, "forward", "decode_z"),
        (gc.tail_z, "forward", "decode_z"), (gc, "finish", "finish")])
    objs = {id(obj) for obj, _, _ in targets}
    assert id(pipe.dec_x) not in objs and id(pipe.dec_z) not in objs
    assert len({(id(o), a) for o, a, _ in targets}) == len(targets)
    assert "finish" in bench.SPANS


class _Clock:
    """A stand-in for `torch.cuda.Event`: each record takes the next tick
    of one counter, so a span's elapsed time counts the records in it."""

    ticks = itertools.count()

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream=None):
        self.t = next(self.ticks)

    def elapsed_time(self, end):
        return float(end.t - self.t)


@pytest.mark.parametrize("gated", [False, True])
def test_spans_of_a_run(monkeypatch, lp04, gated):
    """Every wrapped method of a run at p = 0.06 (stragglers and OSD on
    both paths) records a span, the wrappers leave the counters as they
    were and go away afterwards, and a span counts its own time: the spans
    together take no more than the run, and the finish's time is its own
    less that of the decodes, OSD and classify inside it."""
    pipe = _pipeline(monkeypatch, lp04, gated)
    want = simulate_p(lp04.Hx, lp04.Hz, 0.06, CFG, pipeline=pipe).counters
    monkeypatch.setattr(torch.cuda, "Event", _Clock)
    spans = bench._Spans(pipe, on_card=True)
    start = _Clock()
    start.record()
    with spans.installed():
        got = simulate_p(lp04.Hx, lp04.Hz, 0.06, CFG, pipeline=pipe).counters
    end = _Clock()
    end.record()
    assert got == want
    assert not any(attr in obj.__dict__ for obj, attr, _ in spans.targets())
    names = {name for _, _, name in spans.targets()}
    assert names == set(bench.SPANS) - ({"finish"} if not gated else set())
    assert all(spans.events[name] for name in names)
    assert all(spans.ms(name) > 0 for name in names)
    assert sum(spans.ms(name) for name in bench.SPANS) < start.elapsed_time(end)
    if gated:
        inner = [len(i) for _, _, i in spans.events["finish"]]
        assert min(inner) >= 3    # classify and a tail decode a side at least
        assert spans.ms("finish") == sum(
            e0.elapsed_time(e1) - sum(a.elapsed_time(b) for a, b in i)
            for e0, e1, i in spans.events["finish"])
        outer = sum(e0.elapsed_time(e1) for e0, e1, _ in spans.events["finish"])
        assert spans.ms("finish") < outer
