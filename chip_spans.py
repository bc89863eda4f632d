#!/usr/bin/env python3
"""The program's spans on the card: their clock, their cost, and the device's
idle time of a benchmark cell put down to the program's layers.

    python3 chip_spans.py [--cells NAME,...] [--seed N] [--seconds S]
                          [--out FILE] [--device cuda|cpu]

First, in this process: the cost of `profiling.span()` with spans off and
on (ns a span, timed over many calls), and the offset between the spans'
clock (`time.time_ns()`) and the trace's, from probe ranges traced by
`torch.profiler` between two readings of `time.time_ns()`. Then, per cell of
`BENCHMARK.json` (a cell on several cards starts a process per card through
the program's launcher, as `portbench/run.py` does): the benchmark's set-up
and untraced window (`portbench.harness.Session`), then four pairs of the
harness's own trace pass (`Session.trace_pass`, no program span) and the
same pass with the program's spans on and merged into the trace, each pair
in the other order than the one before. Of each pass with spans: the
device's idle share at the untraced rate (the
`idle_share` reader's arithmetic), its idle gaps by layer
(`portbench.program_idle`), the parts of the idle share, the share of the
gaps under a program span, the gaps by innermost span, the spans a chunk,
and where the pass wraps the pipeline's methods in `record_function`
ranges (`portbench.spans.AnnotatedSpans`, on one card), how far inside each
such range the span it encloses starts and ends. Prints one JSON line per
measurement and appends them to `--out`. `--device cpu` rehearses on the
plain versions at a small size. No check runs.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

ONE_CARD = ("lp118_msl50.p05", "lp118_bposd2.p03", "lp118_msl50.p01")
SMALL = {"shots_per_job_per_card": 1024, "shots_per_card_chunk": 256}
PAIRS = 4          # trace passes without and with spans, per cell


def emit(out, line):
    print(json.dumps(line), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")


def per_span_ns(device, n=200_000, n_on=5_000):
    """ns a `with span(...)` block costs, less the empty loop's time: off
    (`n` blocks) and on (`n_on` blocks, so that few records pile up), each
    with and without arguments; on also under a running profiler; and one
    `time.time_ns()` and one `threading.get_native_id()` call."""
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from qldpcsim_torch.utils import profiling
    from qldpcsim_torch.utils.profiling import span

    def per(body, k):
        best = float("inf")
        for _ in range(3):
            t = time.perf_counter_ns()
            body(k)
            best = min(best, (time.perf_counter_ns() - t) / k)
        return best

    def empty(k):
        for _ in range(k):
            pass

    def bare(k):
        for _ in range(k):
            with span("qldpc.probe"):
                pass

    def args(k):
        for _ in range(k):
            with span("qldpc.probe", p_index=1, chunk=2):
                pass

    def clock(k):
        for _ in range(k):
            time.time_ns()

    def tid(k):
        for _ in range(k):
            threading.get_native_id()

    base, base_on = per(empty, n), per(empty, n_on)
    out = {"off_ns": per(bare, n) - base, "off_args_ns": per(args, n) - base,
           "time_ns_ns": per(clock, n_on) - base_on,
           "native_id_ns": per(tid, n_on) - base_on}
    with profiling.spans_on():
        out["on_ns"] = per(bare, n_on) - base_on
        out["on_args_ns"] = per(args, n_on) - base_on
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    x = torch.ones(8, device=device)
    with profile(activities=acts), profiling.spans_on():
        x = x + 1
        out["on_profiled_ns"] = per(bare, n_on) - base_on
    return out


def clock_offsets(device, probes=20):
    """µs by which a traced `record_function` range starts after the
    `time.time_ns()` reading taken just before it, and ends before the
    reading taken just after it (min, median, max over the probes)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device == "cuda" else [])
    x = torch.ones(1024, device=device)
    reads = []
    with profile(activities=acts) as prof:
        for i in range(probes):
            ta = time.time_ns()
            with record_function(f"probe{i}"):
                x = x + 1
            reads.append((ta, time.time_ns()))
            time.sleep(0.002)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    ev = {e["name"]: e for e in trace["traceEvents"]
          if e.get("ph") == "X" and e.get("name", "").startswith("probe")}
    start, end = [], []
    for i, (ta, tb) in enumerate(reads):
        e = ev[f"probe{i}"]
        t0 = e["ts"] * 1e3 + base
        start.append((t0 - ta) / 1e3)
        end.append((tb - (t0 + e["dur"] * 1e3)) / 1e3)

    def stats(v):
        return [min(v), statistics.median(v), max(v)]

    return {"start_after_us": stats(start), "end_before_us": stats(end),
            "first_start_after_us": start[0]}


def spans_pass(s, index):
    """The harness's trace pass with the program's spans on and merged."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness, program_idle, yardstick
    from portbench.spans import AnnotatedSpans
    from qldpcsim_torch.utils import profiling

    shots = harness.TRACE_CHUNKS * s.cell.batch
    acts = [ProfilerActivity.CPU]
    if s.device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with tempfile.TemporaryDirectory(prefix="chip_spans_") as tmp:
        with AnnotatedSpans().installed(s.slot), \
                profile(activities=acts) as prof, \
                profiling.spans_on() as records:
            t0 = time.perf_counter()
            s._job(index, shots)
            s.sync()
            window_s = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        profiling.merge_spans(path, records)
        events = yardstick.trace_events(path)
    busy = yardstick.union_length(yardstick.device_intervals(events)) * 1e-6
    by_layer = program_idle.idle_by_layer(events)
    by_span = {}
    for secs, name in program_idle.gap_spans(events):
        by_span[name or "(none)"] = by_span.get(name or "(none)", 0.0) + secs
    gaps = sum(by_layer.values())
    # each program span inside the benchmark's range around the same call
    inner = {"portbench.channel": "qldpc.channel",
             "portbench.classify": "qldpc.classify",
             "portbench.osd": "qldpc.osd"}
    ranges = sorted((e for e in events if e["name"] in inner),
                    key=lambda e: e["ts"])
    mine = sorted((e for e in events if e["name"] in inner.values()),
                  key=lambda e: e["ts"])
    lead, lag = [], []
    for r in ranges:
        m = [e for e in mine if e["name"] == inner[r["name"]]
             and abs(e["ts"] - r["ts"]) <= 1e3]
        if m:
            m = min(m, key=lambda e: abs(e["ts"] - r["ts"]))
            lead.append(m["ts"] - r["ts"])
            lag.append(r["ts"] + r["dur"] - m["ts"] - m["dur"])
    chunks = harness.TRACE_CHUNKS
    return {"window_s": window_s, "busy_s": busy, "gaps_s": gaps,
            "covered": 1.0 - by_layer["outside"] / gaps if gaps else None,
            "idle_by_layer": by_layer,
            "idle_by_span": dict(sorted(by_span.items(),
                                        key=lambda kv: -kv[1])[:12]),
            "spans": len(records), "spans_per_chunk": len(records) / chunks,
            "threads": len({r.tid for r in records}),
            "inside_range_us": {
                "start": [min(lead), statistics.median(lead), max(lead)]
                if lead else None,
                "end": [min(lag), statistics.median(lag), max(lag)]
                if lag else None, "pairs": len(lead)}}


def measure(cell, seed, seconds, device):
    """One process's part: set-up, window, then the pairs of trace
    passes."""
    from portbench import harness, program_idle

    s = harness.Session(cell, seed, device=device)
    s.setup()
    win = s.window(seconds)
    per_chunk = win["seconds"] / win["chunks"]
    passes = []
    for k in range(PAIRS):
        # in turns: which of the two passes runs first alternates
        if k % 2:
            spans = spans_pass(s, harness.PASS_INDEX + 2 + k)
            plain = s.trace_pass()
        else:
            plain = s.trace_pass()
            spans = spans_pass(s, harness.PASS_INDEX + 2 + k)
        idle = (1.0 - (spans["busy_s"] / harness.TRACE_CHUNKS) / per_chunk
                if spans["busy_s"] > 0 else None)
        spans["idle_share"] = idle
        spans["idle_parts"] = (program_idle.idle_parts(
            idle, spans["idle_by_layer"]) if idle is not None else None)
        passes.append({"plain_window_s": plain["window_s"],
                       "plain_busy_s": plain["busy_s"], "spans": spans})
    return {"rank": s.rank, "window_s": win["seconds"],
            "chunks": win["chunks"], "shots_per_s": win["shots"] /
            win["seconds"], "chunk_s": per_chunk, "passes": passes}


def load(name, device):
    """The cell `name`, made small on the CPU."""
    from portbench import harness

    cell = harness.load_cell(ROOT, name)
    if device == "cpu":
        cell.traffic = dict(cell.traffic, **SMALL)
        harness.WARM_CHUNKS = harness.TRACE_CHUNKS = 2
    return cell


def run_cell(name, args):
    cell = load(name, args.device)
    if cell.chips == 1:
        return [measure(cell, args.seed, args.seconds, args.device)]
    from qldpcsim_torch.parallel.launch import launch_local

    with tempfile.TemporaryDirectory(prefix="chip_spans_") as tmp:
        argv = ["--rank-of", name, "--seed", str(args.seed), "--seconds",
                str(args.seconds), "--device", args.device, "--out", tmp]
        rc = launch_local(cell.chips, argv,
                          prog=(str(ROOT / "chip_spans.py"),))
        if rc != 0:
            raise RuntimeError(f"a rank of {name} failed with {rc}")
        parts = []
        for r in range(cell.chips):
            with open(os.path.join(tmp, f"part.{r}.json")) as f:
                parts.append(json.load(f))
    return parts


def rank_main(args):
    """A rank of a cell over several cards (started by the launcher)."""
    from portbench import harness
    from qldpcsim_torch.parallel.mesh import multihost_init

    cell = load(args.rank_of, args.device)
    harness.cache_environment(ROOT)
    multihost_init()
    part = measure(cell, args.seed, args.seconds, args.device)
    with open(os.path.join(args.out, f"part.{part['rank']}.json"), "w") as f:
        json.dump(part, f)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="chip_spans.py")
    ap.add_argument("--cells", default=",".join(ONE_CARD))
    ap.add_argument("--seed", type=int, default=2**31 + 77)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--rank-of", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of:
        return rank_main(args)
    import torch

    from portbench import harness, yardstick

    if args.device == "cuda" and not torch.cuda.is_available():
        print("chip_spans.py: torch sees no card", file=sys.stderr)
        return 3
    harness.cache_environment(ROOT)
    emit(args.out, {"what": "machine", "card": yardstick.card_line(),
                    "host": yardstick.host_cpu(), "torch": torch.__version__,
                    "cuda": torch.version.cuda})
    emit(args.out, {"what": "span_cost", **per_span_ns(args.device)})
    emit(args.out, {"what": "clock", **clock_offsets(args.device)})
    for name in args.cells.split(","):
        emit(args.out, {"what": "cell", "cell": name, "seed": args.seed,
                        "parts": run_cell(name, args)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
