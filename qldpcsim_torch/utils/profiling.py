"""Tracing: the program's spans and the `torch.profiler` trace they join.

A span names a stretch of one host thread's time at a layer boundary of the
pipeline (`qldpc.job`, `qldpc.chunk`, `qldpc.decode.x`, ...). Spans are off
by default: `span()` then returns one shared no-op context and records
nothing. Inside `spans_on()` every thread's spans are recorded (name,
thread, enclosing span of the same thread, start and end on
`time.time_ns()`, arguments), whatever thread opened them: `torch.profiler`
records the operators of the thread that started it alone, so the slot
threads of a mesh are seen only here. `merge_spans` writes the records into
a Chrome trace that `torch.profiler` exported, on its clock (`ts` counts
microseconds from the trace's `baseTimeNanoseconds` on `time.time_ns()`'s
clock). Spans change no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import List, Optional


class SpanRecord:
    """One span: its own context, and its record once entered (`end_ns`
    is None while it is open)."""

    __slots__ = ("name", "args", "tid", "parent", "start_ns", "end_ns")

    def __init__(self, name: str, args: dict):
        self.name, self.args = name, args
        self.tid = self.parent = self.start_ns = self.end_ns = None

    def __enter__(self):
        thread = _local
        stack = thread.stack
        self.tid, self.parent = thread.tid, stack[-1] if stack else None
        stack.append(self)
        _append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.time_ns()
        _local.stack.pop()
        return False


class _Thread(threading.local):
    """A thread's id, read once, and its stack of open spans."""

    def __init__(self):
        self.tid = threading.get_native_id()
        self.stack: List[SpanRecord] = []


_on = False
_records: List[SpanRecord] = []
_local = _Thread()


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


def _append(rec: SpanRecord) -> None:
    _records.append(rec)     # one list append: atomic under the GIL


def span(name: str, **args):
    """A context that records the span `name` with `args` inside
    `spans_on()`, and the shared no-op context outside it."""
    if not _on:
        return _OFF
    return SpanRecord(name, args)


@contextlib.contextmanager
def spans_on():
    """Record every thread's spans in this scope; yields the list of the
    records taken in it."""
    global _on, _records
    saved = _on, _records
    _on, _records = True, []
    try:
        yield _records
    finally:
        _on, _records = saved


def merge_spans(trace_path: str, records: List[SpanRecord]) -> int:
    """Add the closed `records` to the Chrome trace at `trace_path` (written
    by `export_chrome_trace`) as complete events of category
    `user_annotation` on their own threads, on the trace's clock. Returns
    the number of events added."""
    with open(trace_path) as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = [{"ph": "X", "cat": "user_annotation", "name": r.name,
               "pid": pid, "tid": r.tid, "ts": (r.start_ns - base) / 1e3,
               "dur": (r.end_ns - r.start_ns) / 1e3, "args": r.args}
              for r in records if r.end_ns is not None]
    trace.setdefault("traceEvents", []).extend(events)
    with open(trace_path, "w") as f:
        json.dump(trace, f)
    return len(events)


@contextlib.contextmanager
def trace_context(name: str, trace_dir: Optional[str] = None,
                  device_only: bool = False):
    """`torch.profiler` trace scope: records CPU activity and the program's
    spans on every thread, and CUDA activity when torch sees a card, under
    the range `name`, and writes `<trace_dir>/<name>.trace.json` (Chrome
    trace format; open it in Perfetto or chrome://tracing). With
    `device_only` it records the card's activity alone (kernels and
    copies: no operator and no span, which keeps the trace's own cost
    small). Yields the profiler; a no-op yielding None when trace_dir is
    None."""
    if trace_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(trace_dir, exist_ok=True)
    activities = [] if device_only else [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof, \
            (contextlib.nullcontext([]) if device_only
             else spans_on()) as records:
        with record_function(name):
            yield prof
    path = os.path.join(trace_dir, f"{name}.trace.json")
    prof.export_chrome_trace(path)
    if records:
        merge_spans(path, records)
