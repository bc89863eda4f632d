"""The benchmark's fixed arithmetic: the card's peak, the operations a decode
needs, the union of the device's intervals in a profiler trace, and the
machine's description. Nothing here imports the program.

The operation counts are those of the decoders' check and variable updates
per edge and iteration: 15 for normalized min-sum, 71 for tanh-product BP
(tanh, running product, division, clip and log per edge). A decode needs the
iterations its shots ran, not the iterations a kernel may spend on them.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# One H100 SXM: float32 outside the tensor cores, the data sheet's dense
# rate at the full 700 W (the card's power limit is printed beside every run)
PEAK_F32_OPS_S = 67e12
OPS_PER_EDGE_ITER = {"MS": 15, "BP": 71}
# trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def decode_ops(kind: str, edges_x: int, edges_z: int, iters_x: int,
               iters_z: int) -> Optional[float]:
    """Operations both sides' decodes needed: the iterations their shots
    ran (summed over shots) times the edges of the side's matrix (X errors
    decode through Hz, Z errors through Hx) times the operations per edge."""
    per_edge = OPS_PER_EDGE_ITER.get(kind.upper())
    if per_edge is None:
        return None
    return float(per_edge * (edges_x * iters_x + edges_z * iters_z))


def merged(intervals: Sequence[Tuple[float, float]]
           ) -> List[Tuple[float, float]]:
    """The union of intervals as disjoint sorted intervals."""
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals."""
    return sum(b - a for a, b in merged(intervals))


def trace_events(path: str) -> List[dict]:
    """The complete events ("ph" X) of a Chrome trace written by
    torch.profiler: name, cat, ts and dur (microseconds)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [{"name": e.get("name", ""), "cat": e.get("cat", ""),
             "ts": float(e["ts"]), "dur": float(e["dur"])}
            for e in events if e.get("ph") == "X" and "dur" in e]


def device_intervals(events: Iterable[dict],
                     cats: Sequence[str] = DEVICE_CATS
                     ) -> List[Tuple[float, float]]:
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e["cat"] in cats]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and parameter
    lists: `void at::native::reduce_kernel<512, ...>(...)` is
    `at::native::reduce_kernel`."""
    depth, out = 0, []
    for ch in name.replace("(anonymous namespace)", "anon"):
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    words = "".join(out).split()
    return words[-1] if words else name


def top_device_ops(events: Iterable[dict], k: int = 10
                   ) -> List[Tuple[str, float]]:
    """The k device operations (by short name) that took most time, in
    seconds."""
    tot: Dict[str, float] = {}
    for e in events:
        if e["cat"] in DEVICE_CATS:
            name = (short_name(e["name"]) if e["cat"] == "kernel"
                    else e["name"])
            tot[name] = tot.get(name, 0.0) + e["dur"] * 1e-6
    return sorted(tot.items(), key=lambda kv: -kv[1])[:k]


def idle_gaps_by_host(events: List[dict], k: int = 10
                      ) -> List[Tuple[str, float]]:
    """The device's idle gaps inside the traced stretch, each named by the
    innermost host event (operator or annotation) under its middle,
    summed by name, in seconds: the k largest."""
    busy = merged(device_intervals(events))
    host = [e for e in events if e["cat"] in ("cpu_op", "user_annotation",
                                              "cuda_runtime",
                                              "cuda_driver")]
    host.sort(key=lambda e: e["ts"])
    tot: Dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        best = None
        for e in host:
            if e["ts"] > mid:
                break
            if e["ts"] + e["dur"] >= mid and (best is None
                                              or e["dur"] < best["dur"]):
                best = e
        name = best["name"] if best is not None else "(no host event)"
        tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
    return sorted(tot.items(), key=lambda kv: -kv[1])[:k]


def invariants_broken(c: Dict[str, int], shots: int,
                      iters: int) -> List[str]:
    """The invariants of a run's nine counters that it breaks: each event
    count within [0, shots], the exact successes among the stabilizer
    successes, a side's successes, failures and logical errors disjoint,
    each iteration sum within [shots, shots x iterations]."""
    broken = [k for k in c if c[k] < 0 or (k[:5] != "nIter" and c[k] > shots)]
    if c["decSuccessExact"] > c["successStabilizer"]:
        broken.append("decSuccessExact <= successStabilizer")
    if c["decSuccessExact"] + c["decSuccessDegen"] > shots:
        broken.append("decSuccessExact + decSuccessDegen <= shots")
    for side in "XZ":
        if (c["successStabilizer"] + c[f"DecFailures_{side}"]
                + c[f"logicalErrors_{side}"] > shots):
            broken.append(f"successStabilizer + DecFailures_{side} + "
                          f"logicalErrors_{side} <= shots")
        if not shots <= c[f"nIterAcc{side}"] <= shots * iters:
            broken.append(f"shots <= nIterAcc{side} <= shots x iterations")
    return broken


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them, or why
    they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30)
        return "; ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi failed: {exc}"


def host_cpu() -> str:
    """The host's CPU from /proc/cpuinfo: its model name where the host
    gives one, else the vendor, family, model and stepping numbers (a
    virtual machine may name its model "unknown"), the clock it reports,
    and the CPUs this process may run on."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, sep, val = line.partition(":")
                val = val.strip()
                if sep and key.strip() not in fields and val and \
                        val.lower() != "unknown":
                    fields[key.strip()] = val
    except OSError:
        pass
    model = next((fields[k] for k in ("model name", "Model Name",
                                      "cpu model", "Hardware")
                  if k in fields), None)
    if model is None:
        ids = [f"{k} {fields[k]}" for k in ("vendor_id", "cpu family",
                                            "model", "stepping",
                                            "CPU implementer", "CPU part")
               if k in fields]
        model = ", ".join(ids) or platform.machine() or "no /proc/cpuinfo"
    if "cpu MHz" in fields:
        model += f", {fields['cpu MHz']} MHz"
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:
        n = os.cpu_count()
    return f"{model}, {n} CPUs"
