"""Spans around the calls into the pipeline's layers, recorded from the
benchmark's side: wrappers installed on the pipeline's own methods for one
pass and removed after it.

`EventSpans` times each call with CUDA events on the current stream (the
layer pass): a span's time is its own, less the spans that ran inside it.
`AnnotatedSpans` opens a `torch.profiler.record_function` range of the
same name around each call (the trace pass), so that the trace shows which
layer the host was in.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

NAMES = ("channel", "decode_x", "decode_z", "osd", "classify")


def targets(pipe) -> List[Tuple[object, str, str]]:
    """(object, method, span) of every call the spans wrap."""
    out = [(pipe, "_sample_chunk", "channel"), (pipe, "classify", "classify"),
           (pipe.dec_x, "forward", "decode_x"),
           (pipe.dec_z, "forward", "decode_z")]
    if getattr(pipe, "use_osd", False):
        out.append((pipe, "_apply_osd", "osd"))
    return out


@contextlib.contextmanager
def _installed(pipe, wrap):
    tg = targets(pipe)
    saved = [obj.__dict__.get(attr) for obj, attr, _ in tg]
    for obj, attr, name in tg:
        setattr(obj, attr, wrap(name, getattr(obj, attr)))
    try:
        yield
    finally:
        for (obj, attr, _), old in zip(tg, saved):
            if old is None:
                del obj.__dict__[attr]
            else:
                obj.__dict__[attr] = old


class EventSpans:
    def __init__(self):
        self.events: Dict[str, list] = {name: [] for name in NAMES}
        self._open: List[list] = []

    def _wrap(self, name, fn):
        def wrapper(*args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            inner: list = []
            e0.record()
            self._open.append(inner)
            try:
                out = fn(*args, **kwargs)
            finally:
                self._open.pop()
            e1.record()
            self.events[name].append((e0, e1, inner))
            if self._open:
                self._open[-1].append((e0, e1))
            return out
        return wrapper

    def installed(self, pipe):
        return _installed(pipe, self._wrap)

    def seconds(self) -> Dict[str, float]:
        """Each span's own seconds (call after a synchronize)."""
        return {name: 1e-3 * sum(
            e0.elapsed_time(e1) - sum(i0.elapsed_time(i1)
                                      for i0, i1 in inner)
            for e0, e1, inner in evs) for name, evs in self.events.items()}


class AnnotatedSpans:
    @staticmethod
    def _wrap(name, fn):
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(f"portbench.{name}"):
                return fn(*args, **kwargs)
        return wrapper

    def installed(self, pipe):
        return _installed(pipe, self._wrap)
