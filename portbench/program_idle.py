"""The device's idle time of a traced pass put down to the program's layers.

The trace is a `torch.profiler` Chrome trace into which the program merged
its spans (`qldpc.*`, category `user_annotation`, on every host thread). Each
idle gap of the device (between two of its busy intervals, the gaps that
`yardstick.idle_gaps_by_host` walks) goes to the innermost (shortest)
`qldpc.*` span that encloses the gap's middle, on any thread, and that span
to its layer. Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from portbench import yardstick

LAYERS = ("decode", "classify", "osd", "channel", "driver", "outside")


def layer_of(name: str) -> str:
    """The layer of the program span `name`: the decodes and the cascades'
    stages are the decode; the job, its key groups, readbacks, a chunk's own
    time and the mesh are the driver."""
    if name.startswith(("qldpc.decode.", "qldpc.cascade.",
                        "qldpc.gcascade.")):
        return "decode"
    if name == "qldpc.classify":
        return "classify"
    if name.startswith("qldpc.osd"):
        return "osd"
    if name == "qldpc.channel":
        return "channel"
    return "driver"


def program_spans(events: Iterable[dict]) -> List[dict]:
    return [e for e in events if e["cat"] == "user_annotation"
            and e["name"].startswith("qldpc.")]


def gap_spans(events: List[dict]) -> List[Tuple[float, Optional[str]]]:
    """(seconds, name of the innermost program span under its middle, or
    None) of each idle gap of the device."""
    busy = yardstick.merged(yardstick.device_intervals(events))
    spans = sorted(program_spans(events), key=lambda e: e["ts"])
    out = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        best = None
        for e in spans:
            if e["ts"] > mid:
                break
            if e["ts"] + e["dur"] >= mid and (best is None
                                              or e["dur"] < best["dur"]):
                best = e
        out.append(((b - a) * 1e-6, best["name"] if best else None))
    return out


def idle_by_layer(events: List[dict]) -> Dict[str, float]:
    """Seconds of the device's idle gaps per layer (`LAYERS`); `outside`
    holds the gaps under no program span."""
    out = dict.fromkeys(LAYERS, 0.0)
    for secs, name in gap_spans(events):
        out[layer_of(name) if name else "outside"] += secs
    return out


def idle_parts(idle_share: float, seconds: Dict[str, float]
               ) -> Dict[str, float]:
    """`idle_share` split over the layers in proportion to their idle
    seconds, so that the parts add up to it."""
    total = sum(seconds.values())
    return {k: idle_share * v / total for k, v in seconds.items()} \
        if total > 0 else {}
