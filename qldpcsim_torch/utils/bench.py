"""The port's benchmark (`bench_torch.py`): the twin of the JAX package's
`bench.py` (the flagship's decoded shots/s) and
`benchmarks/run_configs.py` (the `BASELINE.json` configurations).

For each configuration and p it prints one JSON line: warm shots/s of the
port's normal entry point (`simulate_p`, one pipeline per configuration as
`simulate` keeps one per sweep), the counters, a check of the first shots
against the plain versions on the CPU, and per-layer numbers. Each comes
from a pass of its own on the same pipeline, so that events, counting
wrappers and the profiler stay out of the timed window:

  1. the timed run: `simulate_p` over the configuration's shots; its first
     chunk (kernel builds, warm-up) is left out of the warm window
     (`PPointResult.warm_time_s`). Kernel launches (`ops.launch_counts`)
     and peak device memory are read around it;
  2. the layer pass: `simulate_p` over up to `LAYER_CHUNKS` chunks (as
     many as last about `LAYER_MS` at the timed run's rate) with CUDA
     events around the pipeline's channel, each side's decode, OSD and
     classify (wrappers on the pipeline's own methods; under
     `QLDPC_GROUP_CASCADE=1` a side's decode is its head and tail decoders,
     and the group cascade's `finish` is a span of its own, less the
     decodes, OSD and classify inside it); the residual is the pass's time
     outside every span (the card idle between launches while the host
     works). Host syncs are the pipeline's own counts: one per
     cascade stage reached and side (`Cascade.syncs`, `GroupCascade.
     syncs`), one per OSD compaction (`ShotPipeline.osd_syncs`);
  3. the trace pass: `simulate_p` over up to `TRACE_CHUNKS` chunks
     (about `TRACE_MS`) under `torch.profiler` (`utils/profiling.
     trace_context`, the card's activity alone, shapes not recorded). The
     union of the kernels' intervals a chunk against the timed run's
     untraced chunk gives the device's idle share at the timed rate; the
     traced chunk's ms on the host's clock is the trace's own cost;
  4. the check: the first `CHECK_CHUNKS` chunks of the run's own batch
     (every card of a multi-card run holds shots there) once more through
     the pipeline, and decoded on the CPU by the plain versions in float32:
     the 9 counters equal for MS, BF and NG. For BP (tanh and log round
     differently on the two devices) qBLER within 4 sigma, and on each
     side at most `BP_DIFFER_MAX` of the shots decoded (before OSD) to
     another estimate or iteration count, shot by shot. The timed run's
     own counters are held to their invariants and its qBLER to within 4
     sigma of the check's. `correct` is false otherwise.

`decode_bound_share` is the twin of `bench.py`'s roofline statistic,
counted for one H100: the work the problem required (each side's
iterations times its edges times 15 operations for min-sum or 71 for BP,
plus the channel's 84 per draw and 3 per syndrome edge), over the card's
67 Top/s (float32 outside the tensor cores) and the warm window. A multi-
card configuration runs as one process per card (`parallel/launch.py`),
its counters summed over gloo, its rate timed from the slowest rank's warm
window; rank 0 reports its own layer passes.

On `device="cpu"` the plain versions run and no device number exists: the
spans, the idle share, the peak memory and the bound share are None (the
trace pass runs only with a trace directory, for its trace). A CUDA device
without a card raises; nothing falls back.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import platform
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from qldpcsim_torch.codes import get_code
from qldpcsim_torch.engine.montecarlo import (
    ShotPipeline,
    SimConfig,
    _decoder_choice,
    default_mesh,
    simulate_p,
)
from qldpcsim_torch.decoders.cascade import Cascade
from qldpcsim_torch.ops import _build, launch_counts
from qldpcsim_torch.parallel.keys import chunk_keys
from qldpcsim_torch.parallel.launch import launch_local, launched
from qldpcsim_torch.parallel.mesh import multihost_init, world
from qldpcsim_torch.utils.profiling import trace_context
from qldpcsim_torch.utils.threefry import fold_in, prng_key

# Shots decoded a second before a configuration's warm window lasts
# seconds: its default shots are at least 4 M where the card reaches ~1 M
# shots/s.
M = 1 << 20
STACKED = "QLDPC_QC_STACKED"
# Chunks of the layer and trace passes: at most this many, and as many as
# last about this long at the timed run's rate (a chunk of a plain-torch
# decoder launches tens of thousands of kernels: one chunk is its trace).
LAYER_CHUNKS, LAYER_MS = 16, 500.0
TRACE_CHUNKS, TRACE_MS = 16, 100.0
CHECK_CHUNKS = 2
# BP's check: the largest share of a side's shots whose decode (estimate or
# iteration count, before OSD) may differ between the card and the CPU. On
# one H100, config 5's float32 decodes differed on 5-18 of 8192 shots a
# side (kernels B and F, three seeds) and the bf16 state's on 82-114
BP_DIFFER_MAX = 0.005
# the reference decodes in float32, whatever the run's pipeline reads
PLAIN_ENV = (("QLDPC_QC_DTYPE", None),)
# The card's peak rates (one H100 SXM): float32 outside the tensor cores.
PEAK_OPS_S = 67e12
# Operations the problem requires: per edge and iteration of min-sum and of
# BP, per threefry draw (one per qubit and shot), per syndrome edge.
OPS_PER_EDGE_ITER = {"MS": 15, "BP": 71}
OPS_DRAW = 84
OPS_SYNDROME_EDGE = 3
SPANS = ("channel", "decode_x", "decode_z", "osd", "classify", "finish")
# Column permutation of the non-QC configuration (`chip_smoke.py` phase 17).
PERM_SEED = 118


@dataclasses.dataclass(frozen=True)
class Case:
    """One row set of a configuration: a code and a decoder over its p."""

    config: str                 # the name `--config` selects
    case: str                   # the row's name (run_configs.py's, 1-3)
    code: str                   # a library code (`codes.get_code`)
    dec_type: str
    iters: int
    schedule: str
    ps: Tuple[float, ...]
    shots: Tuple[int, ...]      # default shots, per p
    osd: int = -1
    impl: str = "auto"
    # set (a string) or unset (None) while the pipeline is built
    env: Tuple[Tuple[str, Optional[str]], ...] = ()
    permute: bool = False       # columns permuted on both sides: no lift
    chips: int = 1              # > 1: one process per card
    per_card: int = 0           # a multi-card run's shots per card and chunk
    check_shots: int = 0        # 0: `CHECK_CHUNKS` chunks of the run's batch


_B = ((STACKED, None),)
_F = ((STACKED, "1"),)
CASES: Tuple[Case, ...] = (
    Case("flagship", "flagship", "lp118_0", "MS", 50, "L", (0.05,),
         (4 * M,)),
    Case("flagship_4card", "flagship_4card", "lp118_0", "MS", 50, "L",
         (0.05,), (16 * M,), chips=4, per_card=4096),
    Case("config5_B", "config5_B", "lp118_0", "BP", 99, "F", (0.03,),
         (4 * M,), osd=2, env=_B),
    Case("config5_F", "config5_F", "lp118_0", "BP", 99, "F", (0.03,),
         (4 * M,), osd=2, env=_F),
    Case("msf50_B", "msf50_B", "lp118_0", "MS", 50, "F", (0.05,), (4 * M,),
         env=_B),
    Case("msf50_F", "msf50_F", "lp118_0", "MS", 50, "F", (0.05,), (4 * M,),
         env=_F),
    # the serial decoder's plain version walks the check rows one at a
    # time on the CPU (a 4096-shot chunk took it 28-47 s at p 0.04): its
    # check takes fewer shots
    Case("config4", "config4", "tanner", "MS", 30, "S", (0.01, 0.1),
         (4 * M, M), check_shots=256),
    Case("nonqc", "nonqc", "lp118_0", "MS", 50, "L", (0.05,), (4 * M,),
         permute=True),
    Case("steane_auto", "steane_auto", "steane", "MS", 50, "L", (0.05,),
         (65536,)),
    Case("steane_gh", "steane_gh", "steane", "MS", 50, "L", (0.05,),
         (4 * M,), impl="gh"),
    # configs 1-3 as benchmarks/run_configs.py runs them
    Case("configs_1_3", "1_shor_bp_flood", "shor", "BP", 99, "F",
         (0.01, 0.05), (1000, 1000)),
    Case("configs_1_3", "2_steane_nms_layered", "steane", "MS", 50, "L",
         (0.01, 0.03, 0.05), (20000,) * 3),
    Case("configs_1_3", "3_bicycle_bf", "bicycle", "BF", 50, "F",
         (0.01, 0.03), (5000,) * 2),
    Case("configs_1_3", "3_bicycle_ng", "bicycle", "NG", 0, "F",
         (0.01, 0.03), (5000,) * 2),
)
CONFIGS = tuple(dict.fromkeys(c.config for c in CASES))


@contextlib.contextmanager
def environ(pairs: Sequence[Tuple[str, Optional[str]]]):
    """The environment with `pairs` set (a string) or unset (None), put
    back as it was on the way out."""
    old = {k: os.environ.get(k) for k, _ in pairs}
    try:
        for k, v in pairs:
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def matrices(case: Case) -> Tuple[np.ndarray, np.ndarray]:
    """(Hx, Hz) of a case: the library code, its columns permuted on both
    sides for the non-QC configuration."""
    code = get_code(case.code)
    Hx, Hz = np.asarray(code.Hx) % 2, np.asarray(code.Hz) % 2
    if case.permute:
        perm = np.random.default_rng(PERM_SEED).permutation(Hx.shape[1])
        Hx, Hz = Hx[:, perm], Hz[:, perm]
    return Hx.astype(np.int8), Hz.astype(np.int8)


def sim_config(case: Case, shots: int, seed: int, device: str, mesh=None,
               batch: int = 0):
    """The case's `SimConfig`: `batch` shots a chunk if given, else
    `per_card` shots a card and chunk, and a run shorter than that takes
    the automatic (smaller) chunk."""
    if not batch:
        batch = case.per_card * (mesh.size if mesh is not None else 1)
        if shots < batch:
            batch = 0
    return SimConfig(shots=shots, dec_type=case.dec_type,
                     dec_iterations=case.iters, dec_schedule=case.schedule,
                     osd_order=case.osd, rng_seed=seed, impl=case.impl,
                     batch_size=batch, device=device, mesh=mesh)


def make_pipeline(case: Case, Hx, Hz, cfg):
    """The measured pipeline, built under the case's environment."""
    with environ(case.env):
        return ShotPipeline(Hx, Hz, cfg)


def check_shots(case: Case, shots: int, batch: int) -> int:
    """Shots of the check: the case's own count, else the run's first
    `CHECK_CHUNKS` chunks."""
    return min(shots, case.check_shots or CHECK_CHUNKS * batch)


def decode_chunks(pipe: ShotPipeline, p: float, p_index: int, shots: int,
                  seed: int):
    """Both sides' decodes (before OSD) of the first `shots` shots of key
    branch `p_index`, drawn chunk by chunk as `simulate_p` draws them: per
    side, (iteration counts, estimates) on the CPU."""
    key = fold_in(prng_key(seed, device=pipe.device), p_index)
    tpc = pipe.tiles_per_chunk
    sides = {"x": ([], []), "z": ([], [])}
    for c in range(-(-shots // pipe.batch)):
        keys = chunk_keys(key, c * tpc, tpc).reshape(tpc, 2)
        _, _, sy_z, sy_x = pipe._sample_chunk(keys, p)
        n_valid = min(pipe.batch, shots - c * pipe.batch)
        for side, r in zip("xz", pipe._decode_sides(sy_z, sy_x, p)):
            sides[side][0].append(r.n_iter[:n_valid].cpu())
            sides[side][1].append(r.e_hat[:n_valid].cpu())
    return {side: (torch.cat(it), torch.cat(e))
            for side, (it, e) in sides.items()}


def decodes_differ(run, plain) -> Dict[str, int]:
    """Shots whose iteration count or estimate differs between two
    `decode_chunks` of the same shots, per side."""
    return {side: int(((run[side][0] != plain[side][0])
                       | (run[side][1] != plain[side][1]).any(dim=1)).sum())
            for side in run}


def counters_of(r) -> Dict[str, int]:
    """The 9 counters of a `PPointResult` (the iteration sums exactly)."""
    return dict(r.counters, nIterAccX=int(round(r.avg_iterations_x * r.shots)),
                nIterAccZ=int(round(r.avg_iterations_z * r.shots)))


def qbler(c: Dict[str, int], shots: int) -> float:
    return 1.0 - (c["decSuccessExact"] + c["decSuccessDegen"]) / shots


def four_sigma(a: float, n_a: int, b: float, n_b: int) -> float:
    """4 sigma of the difference of two qBLER estimates over n_a and n_b
    shots (the pooled rate)."""
    pool = (a * n_a + b * n_b) / (n_a + n_b)
    return 4 * math.sqrt(max(pool * (1 - pool), 1e-12) * (1 / n_a + 1 / n_b))


def check_verdict(dec_type: str, run: Dict[str, int], plain: Dict[str, int],
                  shots: int, differ: Optional[Dict[str, int]] = None
                  ) -> dict:
    """`run`'s counters against the plain versions' on the same shots:
    equal for MS, BF and NG. For BP qBLER within 4 sigma, and on each side
    at most `BP_DIFFER_MAX` of the shots decoded otherwise (`differ`, from
    `decodes_differ`)."""
    out = {"shots": shots, "run": run, "plain": plain}
    if dec_type.upper() != "BP":
        return dict(out, rule="equal", correct=run == plain)
    a, b = qbler(run, shots), qbler(plain, shots)
    sigma4 = four_sigma(a, shots, b, shots)
    differ_max = int(BP_DIFFER_MAX * shots)
    return dict(
        out, rule="qBLER within 4 sigma, decodes shot by shot",
        qBLER_diff=abs(a - b), four_sigma=sigma4, differ=differ,
        differ_max=differ_max,
        correct=(abs(a - b) <= sigma4 and differ is not None
                 and max(differ.values()) <= differ_max))


def invariants_broken(c: Dict[str, int], shots: int,
                      iters: int) -> List[str]:
    """The counter invariants a run's 9 counters break: each event count
    within [0, shots], the exact successes among the stabilizer successes,
    a side's successes, failures and logical errors disjoint, and each
    iteration sum within [0, shots x iterations] (iterations 0: no upper
    bound)."""
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
        if iters and c[f"nIterAcc{side}"] > shots * iters:
            broken.append(f"nIterAcc{side} <= shots x iterations")
    return broken


def timed_verdict(timed: Dict[str, int], shots: int, plain: Dict[str, int],
                  n_check: int, iters: int) -> dict:
    """The timed run's own counters: their invariants, and their qBLER
    within 4 sigma of the check's plain run (the same distribution)."""
    a, b = qbler(timed, shots), qbler(plain, n_check)
    sigma4 = four_sigma(a, shots, b, n_check)
    broken = invariants_broken(timed, shots, iters)
    return {"invariants_broken": broken, "qBLER_diff": abs(a - b),
            "four_sigma": sigma4,
            "correct": not broken and abs(a - b) <= sigma4}


def required_ops_per_shot(dec_type: str, Hx, Hz, avg_x: float,
                          avg_z: float) -> Optional[float]:
    """Operations one shot requires on average (None for BF and NG, which
    have no count in the port's table): X errors decode through Hz, Z
    errors through Hx."""
    per_edge = OPS_PER_EDGE_ITER.get(dec_type.upper())
    if per_edge is None:
        return None
    nnz_x, nnz_z = int(Hx.sum()), int(Hz.sum())
    return (per_edge * (nnz_z * avg_x + nnz_x * avg_z)
            + OPS_DRAW * Hx.shape[1] + OPS_SYNDROME_EDGE * (nnz_x + nnz_z))


def union_share(intervals: Sequence[Tuple[float, float]]
                ) -> Tuple[float, float]:
    """(busy time, window) of intervals: the length of their union and the
    span from the first start to the last end."""
    ivs = sorted(intervals)
    busy, cur_lo, cur_hi = 0.0, ivs[0][0], ivs[0][1]
    for lo, hi in ivs[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    # the last merged run ends last
    return busy + cur_hi - cur_lo, cur_hi - ivs[0][0]


def kernel_intervals(trace_path: str) -> List[Tuple[float, float]]:
    """The device kernels' (start, end) in µs of a Chrome trace written by
    `torch.profiler`."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "kernel" and "dur" in e]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def host_cpu() -> str:
    """The host's CPU model (`/proc/cpuinfo`, else `platform`) and its
    CPU count."""
    model = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{model}, {os.cpu_count()} CPUs"


def _num(x) -> Optional[float]:
    """A float for JSON, None for NaN."""
    return None if x is None or x != x else float(x)


def host_syncs(pipe: ShotPipeline) -> Dict[str, int]:
    """The host syncs a pipeline has counted so far: its cascades' (one per
    stage reached and side, the group cascade's own) and its OSD
    compactions'."""
    gc = pipe.group_cascade
    cascade = sum(d.syncs for d in (pipe.dec_x, pipe.dec_z)
                  if isinstance(d, Cascade))
    if gc is not None:
        cascade += gc.syncs
    return {"cascade": cascade, "osd": pipe.osd_syncs}


class _Spans:
    """CUDA-event spans around a pipeline's stages, installed on the
    pipeline's own methods for the layer pass and removed after it. A span
    is its own time: a span that runs inside another (the group finish's
    tail decodes, OSD and classify) counts in its own name alone."""

    WRAPPED = (("_sample_chunk", "channel"), ("classify", "classify"),
               ("_apply_osd", "osd"))

    def __init__(self, pipe, on_card: bool):
        self.pipe = pipe
        self.on_card = on_card
        # per span, (start, end, the spans that ran inside it)
        self.events = {name: [] for name in SPANS}
        self._open: List[list] = []

    def targets(self) -> List[Tuple[object, str, str]]:
        """(object, method, span) of every method the layer pass wraps:
        each side's decoders (under the group cascade its head and tail)
        and, under the group cascade, its finish."""
        pipe = self.pipe
        out = [(pipe, attr, name) for attr, name in self.WRAPPED]
        gc = pipe.group_cascade
        if gc is None:
            return out + [(pipe.dec_x, "forward", "decode_x"),
                          (pipe.dec_z, "forward", "decode_z")]
        return out + [(gc.head_x, "forward", "decode_x"),
                      (gc.tail_x, "forward", "decode_x"),
                      (gc.head_z, "forward", "decode_z"),
                      (gc.tail_z, "forward", "decode_z"),
                      (gc, "finish", "finish")]

    def _timed(self, name, fn):
        def wrapper(*args, **kwargs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            inner = []
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

    @contextlib.contextmanager
    def installed(self):
        if not self.on_card:
            yield self
            return
        targets = self.targets()
        for obj, attr, name in targets:
            setattr(obj, attr, self._timed(name, getattr(obj, attr)))
        try:
            yield self
        finally:
            for obj, attr, _ in targets:
                del obj.__dict__[attr]

    def ms(self, name) -> float:
        """The span's ms, less those of the spans inside it."""
        return sum(e0.elapsed_time(e1)
                   - sum(i0.elapsed_time(i1) for i0, i1 in inner)
                   for e0, e1, inner in self.events[name])


class Bench:
    """The passes of one configuration's case on one pipeline; `point(i)`
    measures its i-th p and returns the JSON line."""

    def __init__(self, case: Case, ps: Sequence[float], shots: Sequence[int],
                 seed: int, device: str, chips: int,
                 trace_dir: Optional[str]):
        if case.dec_type.upper() == "BP" and chips > 1:
            raise ValueError("bench: BP's check compares one pipeline's "
                             "decodes shot by shot; run it on one card")
        self.case, self.ps, self.shots = case, list(ps), list(shots)
        self.seed = seed
        self.device, self.chips, self.trace_dir = device, chips, trace_dir
        self.on_card = device == "cuda"
        self.rank, self.world = world()
        self.Hx, self.Hz = matrices(case)
        mesh = default_mesh(device) if chips > 1 else None
        self.cfg = sim_config(case, max(self.shots), seed, device, mesh)
        self.pipe = make_pipeline(case, self.Hx, self.Hz, self.cfg)
        # the slot this process drives (the pipeline itself without a mesh)
        self.slot = (self.pipe.slots[0] if self.pipe.slots is not None
                     else self.pipe)
        self._plain = None

    def plain_pipe(self) -> ShotPipeline:
        """The check's pipeline: the plain versions on the CPU, float32, the
        run's batch (built once, on first use)."""
        if self._plain is None:
            cfg = sim_config(self.case, max(self.shots), self.seed, "cpu",
                             batch=self.pipe.batch)
            with environ(self.case.env + PLAIN_ENV):
                self._plain = ShotPipeline(self.Hx, self.Hz, cfg)
        return self._plain

    def _run(self, p, p_index, shots, pipe=None):
        pipe = pipe or self.pipe
        return simulate_p(self.Hx, self.Hz, p,
                          dataclasses.replace(pipe.cfg, shots=shots),
                          pipeline=pipe, p_index=p_index)

    def _max_over_ranks(self, x: float) -> float:
        if self.world == 1:
            return x
        t = torch.tensor([x], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t[0])

    def _timed_run(self, p, p_index, shots):
        """Pass 1: the timed run, with launches and peak memory around
        it."""
        if self.on_card:
            torch.cuda.synchronize(self.slot.device)
            torch.cuda.reset_peak_memory_stats(self.slot.device)
        before = launch_counts()
        r = self._run(p, p_index, shots)
        after = launch_counts()
        peak = (torch.cuda.max_memory_allocated(self.slot.device)
                if self.on_card else None)
        n_chunks = -(-shots // self.pipe.batch)
        launches = {k: (after[k] - before[k]) / n_chunks for k in after
                    if after[k] != before[k]}
        return r, launches, peak, n_chunks

    def _pass_shots(self, shots, cap, target_ms, warm_ms):
        """Shots of a pass: at most `cap` chunks, and as many as last about
        `target_ms` at `warm_ms` a chunk (one at least)."""
        if warm_ms is not None:
            cap = max(1, min(cap, int(target_ms // warm_ms)))
        return min(shots, cap * self.pipe.batch)

    def _layer_pass(self, p, p_index, n):
        """Pass 2: spans and host syncs per chunk over n shots."""
        chunks = -(-n // self.pipe.batch)
        spans = _Spans(self.slot, self.on_card)
        syncs0 = host_syncs(self.slot)
        with spans.installed():
            if self.on_card:
                # on the slot's card: a rank of a multi-card run owns one
                # card, and an event on another would make a context there
                stream = torch.cuda.current_stream(self.slot.device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record(stream)
            self._run(p, p_index, n)
            if self.on_card:
                end.record(stream)
                end.synchronize()
        syncs = {k: (v - syncs0[k]) / chunks
                 for k, v in host_syncs(self.slot).items()}
        if not self.on_card:
            return None, syncs, chunks
        layers = {name: spans.ms(name) / chunks for name in SPANS}
        total = start.elapsed_time(end) / chunks
        layers["residual"] = total - sum(layers.values())
        layers["total"] = total
        return layers, syncs, chunks

    def _trace_pass(self, p, p_index, n):
        """Pass 3, over n shots: the card's busy ms a chunk (the union of
        the traced kernels), the traced ms a chunk on the host's clock (the
        trace's cost beside the timed run's) and the kernels traced."""
        chunks = -(-n // self.pipe.batch)
        name = f"{self.case.config}_{self.case.case}_p{p}"
        if self.world > 1:
            name += f"_rank{self.rank}"
        with contextlib.ExitStack() as stack:
            trace_dir = self.trace_dir or stack.enter_context(
                tempfile.TemporaryDirectory(prefix="qldpc_trace_"))
            with trace_context(name, trace_dir, device_only=self.on_card):
                t0 = time.perf_counter()
                self._run(p, p_index, n)
                if self.on_card:
                    torch.cuda.synchronize(self.slot.device)
                ms = 1e3 * (time.perf_counter() - t0) / chunks
            ivs = kernel_intervals(os.path.join(trace_dir,
                                                f"{name}.trace.json"))
        if not self.on_card or not ivs:
            return None, ms, len(ivs)
        return 1e-3 * union_share(ivs)[0] / chunks, ms, len(ivs)

    def _check(self, r, p, i, shots):
        """Pass 4: the check of the first shots against the plain versions
        on the CPU, and the timed run's own counters (rank 0 returns the
        verdicts, the other ranks None)."""
        case = self.case
        n_check = check_shots(case, shots, self.pipe.batch)
        bp = case.dec_type.upper() == "BP"
        # a run no longer than the check is its own first shots
        run = counters_of(r if n_check == shots else self._run(p, i, n_check))
        if bp:
            run_dec = decode_chunks(self.pipe, p, i, n_check, self.seed)
        if self.world > 1:
            dist.barrier()
        if self.rank != 0:
            return None, None
        plain_pipe = self.plain_pipe()
        plain = counters_of(self._run(p, i, n_check, pipe=plain_pipe))
        differ = (decodes_differ(run_dec, decode_chunks(
            plain_pipe, p, i, n_check, self.seed)) if bp else None)
        return (check_verdict(case.dec_type, run, plain, n_check, differ),
                timed_verdict(counters_of(r), shots, plain, n_check,
                              case.iters))

    def point(self, i: int) -> Optional[dict]:
        """The line of p-point i (None on ranks other than 0)."""
        case, p, shots = self.case, self.ps[i], self.shots[i]
        r, launches, peak, n_chunks = self._timed_run(p, i, shots)
        warm_time = self._max_over_ranks(r.warm_time_s)
        wall = self._max_over_ranks(r.wall_time_s)
        warm_rate = warm_ms = None
        if r.warm_shots and warm_time == warm_time:
            warm_rate = r.warm_shots / warm_time
            warm_ms = 1e3 * self.pipe.batch / warm_rate
        layers, syncs, layer_chunks = self._layer_pass(
            p, i, self._pass_shots(shots, LAYER_CHUNKS, LAYER_MS, warm_ms))
        busy_ms = trace_ms = n_kernels = None
        if self.on_card or self.trace_dir is not None:
            busy_ms, trace_ms, n_kernels = self._trace_pass(
                p, i, self._pass_shots(shots, TRACE_CHUNKS, TRACE_MS,
                                       warm_ms))
        check, timed = self._check(r, p, i, shots)
        if check is None:
            return None
        counts = counters_of(r)
        ops = required_ops_per_shot(case.dec_type, self.Hx, self.Hz,
                                    r.avg_iterations_x, r.avg_iterations_z)
        bound_share = None
        if self.on_card and ops is not None and warm_rate is not None:
            bound_share = ops * warm_rate / (PEAK_OPS_S * self.chips)
        return {
            "config": case.config, "case": case.case, "code": case.code,
            "permuted": case.permute, "decoder": case.dec_type,
            "schedule": case.schedule, "iterations": case.iters,
            "osd": case.osd, "impl": case.impl,
            "env": {k: v for k, v in case.env},
            "decoders": [_decoder_choice(self.slot.dec_x),
                         _decoder_choice(self.slot.dec_z)],
            "p": p, "shots": shots, "seed": self.seed,
            "device": self.device, "chips": self.chips,
            "batch": self.pipe.batch, "chunks": n_chunks,
            # end to end
            "shots_per_s_warm": warm_rate, "warm_shots": r.warm_shots,
            "warm_time_s": _num(warm_time), "wall_time_s": wall,
            "shots_per_s": shots / wall if wall else None,
            **counts,
            "qBLER": r.qbler, "qBLER_honest": r.qbler_honest,
            "avg_iters_X": r.avg_iterations_x,
            "avg_iters_Z": r.avg_iterations_z,
            "correct": bool(check["correct"] and timed["correct"]),
            "check": check, "timed_check": timed,
            # per layer
            "layer_chunks": layer_chunks,
            "layers_ms_per_chunk": layers,
            "launches_per_chunk": launches,
            "host_syncs_per_chunk": syncs,
            # the traced kernels' union a chunk against the untraced chunk:
            # the device's idle share at the timed run's rate
            "idle_share": (1.0 - busy_ms / warm_ms
                           if busy_ms is not None and warm_ms else None),
            "busy_ms_per_chunk": busy_ms,
            "warm_ms_per_chunk": warm_ms,
            "trace_kernels": n_kernels,
            # a traced chunk on the host's clock: the trace's own cost
            "trace_ms_per_chunk": _num(trace_ms),
            "peak_mem_bytes": peak,
            "required_ops_per_shot": ops,
            "decode_bound_share": bound_share,
            # the machine
            "card": card_line() if self.on_card else None,
            "host_cpu": host_cpu(), "torch": torch.__version__,
        }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bench_torch.py",
        description="Warm decoded shots/s of the port's main paths, with "
                    "counters, a CPU check and per-layer numbers: one JSON "
                    "line per configuration and p.")
    ap.add_argument("--config", action="append", default=None,
                    choices=CONFIGS + ("all",), metavar="NAME",
                    help="a configuration (repeatable, run in the order "
                         f"given), or all: {', '.join(CONFIGS)}")
    ap.add_argument("--shots", type=int, default=None,
                    help="shots per p (default: each configuration's own)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs the kernels and raises without a card; "
                         "cpu runs their plain versions")
    ap.add_argument("--chips", type=int, default=None,
                    help="cards of a multi-card configuration (default its "
                         "own: flagship_4card 4), one process each")
    ap.add_argument("--out", default=None, help="also write the JSON lines "
                                                "to this file")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="keep the trace pass's torch.profiler traces in "
                         "DIR (Chrome trace format)")
    return ap


def _launch(script: str, chips: int, name: str, args) -> Tuple[int, list]:
    """`name` as `chips` processes of `script` (`parallel/launch.py`): rank
    0's lines stream to this process's stdout; (status, its lines)."""
    with tempfile.TemporaryDirectory(prefix="qldpc_bench_") as tmp:
        out = os.path.join(tmp, "lines.jsonl")
        argv = ["--config", name, "--seed", str(args.seed), "--device",
                args.device, "--chips", str(chips), "--out", out]
        if args.shots is not None:
            argv += ["--shots", str(args.shots)]
        if args.profile is not None:
            argv += ["--profile", os.path.abspath(args.profile)]
        rc = launch_local(chips, argv, prog=(script,))
        lines = []
        if os.path.exists(out):
            with open(out) as f:
                lines = [json.loads(line) for line in f]
    return rc, lines


def main(argv: Optional[Sequence[str]] = None,
         script: Optional[str] = None) -> int:
    """Run the configurations; 0 when every line is correct, 1 when one is
    not (after printing it). `script` is the file a multi-card
    configuration starts once per card."""
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench: --device cuda but torch sees no CUDA "
                           "device; --device cpu runs the plain versions")
    names = args.config or ["flagship"]
    every = "all" in names
    names = [n for sel in names
             for n in (CONFIGS if sel == "all" else (sel,))]
    if launched():
        multihost_init()
    elif args.device == "cuda":
        _build.load_all()   # one nvcc per source, all at once
    lead = world()[0] == 0
    lines, ok = [], True
    for name in names:
        cases = [c for c in CASES if c.config == name]
        chips = (args.chips or cases[0].chips) if cases[0].chips > 1 else 1
        if chips > 1 and not launched():
            if (args.device == "cuda"
                    and torch.cuda.device_count() < chips):
                why = (f"needs {chips} cards, torch sees "
                       f"{torch.cuda.device_count()}")
                if not every:
                    raise RuntimeError(f"bench: {name} {why}")
                line = {"config": name, "skipped": why, "correct": None}
                print(json.dumps(line), flush=True)
                lines.append(line)
                continue
            if script is None:
                raise ValueError(f"bench: {name} runs one process per card "
                                 "and needs the script to start")
            rc, got = _launch(script, chips, name, args)
            ok &= rc == 0 and bool(got) and all(g["correct"] for g in got)
            lines += got
            continue
        for case in cases:
            shots = (case.shots if args.shots is None
                     else [args.shots] * len(case.ps))
            bench = Bench(case, case.ps, shots, args.seed, args.device,
                          chips, args.profile)
            for i in range(len(case.ps)):
                line = bench.point(i)
                if line is None:
                    continue
                print(json.dumps(line), flush=True)
                lines.append(line)
                ok &= line["correct"]
    if lead and args.out:
        with open(args.out, "w") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0 if ok else 1
