"""The benchmark of `qldpcsim_torch`: one cell of `BENCHMARK.json` per run.

A cell names a configuration (`portbench/configs/<name>.json`: the code's
matrices, the decoder, the OSD order, the chips, the environment the
pipeline is built under and the check's sample sizes and limits) and a
traffic mix (`portbench/traffic/<name>.json`: p, the shots of a job per
card, the shots per card and chunk). Per-layer metrics are readers of their
own (`portbench/metrics/<name>.py`). Nothing here names a cell.

A run, in one process per card:

  set-up   the program imported, its kernels loaded from the build
           directory inside the checkout (built there by the first run),
           one `ShotPipeline` for the cell, a warm job of a few chunks at
           the cell's p;
  window   jobs, one after another: each is `simulate_p(Hx, Hz, p, cfg,
           pipeline=pipe, p_index=k)` over the job's shots on key branch
           k = 1, 2, ... of `--seed`, the users' qBLER point. Every job that
           starts before `--seconds` have passed belongs to the window, which
           ends when the last one has returned (its counters are on the
           host). On several cards every rank runs the same jobs over
           `cfg.mesh`, rank 0 decides when to stop, and the window is the
           slowest rank's;
  trace    (`--trace 1`) after the same window: a layer pass (CUDA events
           around the pipeline's layers) and a trace pass (`torch.profiler`,
           device and host), each one job of its own;
  check    the chunks the window kept, against the plain reference
           (`check.py`), after the window and the memory reading.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from portbench import check, yardstick

# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "qldpcsim_tpu")
PROGRAM = "qldpcsim_torch"
WARM_INDEX = 0                  # key branch of the warm job
PASS_INDEX = 1 << 30            # key branches of the layer and trace passes
WARM_CHUNKS = 4                 # chunks per card of the warm job
LAYER_CHUNKS = 64               # chunks per card of the layer pass
TRACE_CHUNKS = 16               # chunks per card of the trace pass


class CellError(RuntimeError):
    """A run that cannot measure: it exits non-zero and prints no result."""


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    root: Path
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def batch(self) -> int:
        return int(self.traffic["shots_per_card_chunk"]) * self.chips

    @property
    def job_shots(self) -> int:
        return int(self.traffic["shots_per_job_per_card"]) * self.chips

    @property
    def p(self) -> float:
        return float(self.traffic["p"])

    def path(self, rel: str) -> Path:
        return self.root / rel


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: Path, name: str) -> Cell:
    """The cell `name` of `root/BENCHMARK.json` with its configuration and
    traffic files."""
    root = Path(root)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    if int(config["chips"]) != int(w["chips"]):
        raise CellError(f"{name}: the cell asks for {w['chips']} chips, its "
                        f"configuration runs on {config['chips']}")
    return Cell(name=name, config_name=w["config"],
                traffic_name=w["traffic"], chips=int(w["chips"]),
                config=config, traffic=traffic, root=root,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def forbidden_modules() -> List[str]:
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def job_chunk(seed: int, job: int, n_chunks: int) -> int:
    """The chunk a job keeps for the check, drawn from the seed."""
    return int(np.random.default_rng([seed, job, 1]).integers(n_chunks))


def job_sample(seed: int, job: int, rows: int, k: int) -> np.ndarray:
    """The shots of the kept chunk whose decodes are compared."""
    rng = np.random.default_rng([seed, job, 2])
    return np.sort(rng.choice(rows, size=min(k, rows), replace=False))


@contextlib.contextmanager
def environment(pairs: Dict[str, Optional[str]]):
    """The environment with `pairs` set (a string) or unset (None)."""
    old = {k: os.environ.get(k) for k in pairs}
    try:
        for k, v in pairs.items():
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


def cache_environment(root: Path) -> None:
    """Every build and kernel cache of the program inside the checkout, at
    fixed paths: the first run of a checkout builds, later runs load."""
    build = root / "build"
    os.environ["QLDPC_TORCH_BUILD_DIR"] = str(build / "qldpcsim_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


class Session:
    """One process's part of a run: its pipeline (a card's slot of the
    mesh on several cards), its window, passes and kept chunks."""

    def __init__(self, cell: Cell, seed: int, device: str = "cuda",
                 control: bool = False):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.control = control
        self.parts: Dict[str, float] = {}
        self.wait_s = 0.0

    # set-up ----------------------------------------------------------
    def setup(self) -> None:
        t = time.perf_counter()
        import torch
        from qldpcsim_torch.engine import montecarlo
        from qldpcsim_torch.ops import _build
        from qldpcsim_torch.parallel import mesh as mesh_mod

        self.torch, self.mc, self.mesh_mod = torch, montecarlo, mesh_mod
        self.parts["import_s"] = time.perf_counter() - t
        cell, conf = self.cell, self.cell.config
        self.rank, self.world = mesh_mod.world()
        t = time.perf_counter()
        if self.device == "cuda" and self.world == 1:
            _build.load_all()
        self.parts["kernels_s"] = time.perf_counter() - t
        t = time.perf_counter()
        self.Hx = np.load(cell.path(conf["code"]["Hx"]))
        self.Hz = np.load(cell.path(conf["code"]["Hz"]))
        mesh = None
        if cell.chips > 1:
            mesh = (mesh_mod.make_mesh() if self.device == "cuda"
                    else mesh_mod.make_mesh(["cpu"]))
            if mesh.size != cell.chips:
                raise CellError(f"{cell.name}: a mesh of {mesh.size} slots "
                                f"for {cell.chips} chips")
        dec = conf["decoder"]
        self.cfg = montecarlo.SimConfig(
            shots=cell.job_shots, dec_type=dec["type"],
            dec_iterations=int(dec["iterations"]),
            dec_schedule=dec["schedule"], osd_order=int(conf["osd_order"]),
            rng_seed=self.seed, batch_size=cell.batch, device=self.device,
            mesh=mesh)
        env = dict(conf["env"])
        if self.control:
            env.update(conf["control"]["env"])
        with environment(env):
            self.pipe = montecarlo.ShotPipeline(self.Hx, self.Hz, self.cfg)
        self.slot = (self.pipe.slots[0] if self.pipe.slots is not None
                     else self.pipe)
        self._check_configuration()
        self.parts["pipeline_s"] = time.perf_counter() - t
        from portbench.capture import Capture
        self.capture = Capture(self.slot)
        if self.world > 1:
            self._time_allreduce()
        t = time.perf_counter()
        self._job(WARM_INDEX, WARM_CHUNKS * cell.batch, keep=True)
        self.sync()
        self.parts["warm_s"] = time.perf_counter() - t

    def _check_configuration(self) -> None:
        """The pipeline runs as the configuration states: its decoders are
        the ones named there (kernel, state dtype), with its beta."""
        conf = self.cell.config
        want = conf["control"]["decoder"] if self.control else conf[
            "expect"]["decoder"]
        got = [self.mc._decoder_choice(d) for d in (self.slot.dec_x,
                                                    self.slot.dec_z)]
        first = [d.decs[0] if hasattr(d, "decs") else d
                 for d in (self.slot.dec_x, self.slot.dec_z)]
        beta = [getattr(d, "beta", None) for d in first]
        if got != [want, want] or any(
                b is not None and b != float(np.float32(
                    conf["decoder"]["beta"])) for b in beta):
            raise CellError(f"{self.cell.name}: the pipeline's decoders are "
                            f"{got} (beta {beta}), the configuration states "
                            f"{want} (beta {conf['decoder']['beta']})")
        if self.slot.group_cascade is not None:
            raise CellError(f"{self.cell.name}: the group cascade is on")

    def _time_allreduce(self) -> None:
        """Seconds this rank spends in the counters' all-reduce (waiting for
        the other ranks included), from a wrapper on the mesh module's
        function; `_go_on` adds its own."""
        mod = self.mesh_mod
        fn = mod.allreduce_counters_host

        def timed(counts):
            t = time.perf_counter()
            try:
                return fn(counts)
            finally:
                self.wait_s += time.perf_counter() - t

        mod.allreduce_counters_host = timed

    def reseed(self, seed: int) -> None:
        """Later windows draw from `seed` (the pipeline does not depend on
        it)."""
        self.seed = int(seed)
        self.cfg = dataclasses.replace(self.cfg, rng_seed=self.seed)

    def sync(self) -> None:
        if self.device == "cuda":
            self.torch.cuda.synchronize(self.slot.device)

    def _job(self, p_index: int, shots: int, keep: bool = False):
        """One job; with `keep` its kept chunk and counters."""
        from portbench.capture import JobCapture

        n_chunks = shots // self.cell.batch
        if keep:
            rows = job_sample(self.seed, p_index, self.slot.batch, int(
                self.cell.config["check"]["decode_shots_per_job"]))
            self.capture.start(JobCapture(
                p_index, job_chunk(self.seed, p_index, n_chunks),
                self.torch.as_tensor(rows)))
        r = self.mc.simulate_p(
            self.Hx, self.Hz, self.cell.p,
            dataclasses.replace(self.cfg, shots=shots), pipeline=self.pipe,
            p_index=p_index)
        kept = self.capture.stop() if keep else None
        counts = dict(r.counters,
                      nIterAccX=int(round(r.avg_iterations_x * shots)),
                      nIterAccZ=int(round(r.avg_iterations_z * shots)))
        return counts, kept

    def host_syncs(self) -> int:
        """Host syncs the slot's pipeline counted so far: one per cascade
        stage reached and side, one per OSD compaction."""
        from qldpcsim_torch.decoders.cascade import Cascade

        return sum(d.syncs for d in (self.slot.dec_x, self.slot.dec_z)
                   if isinstance(d, Cascade)) + self.slot.osd_syncs

    def _go_on(self, go: bool) -> bool:
        if self.world == 1:
            return go
        import torch.distributed as dist

        t = time.perf_counter()
        flag = self.torch.tensor([int(go)], dtype=self.torch.int64)
        dist.broadcast(flag, src=0)
        self.wait_s += time.perf_counter() - t
        return bool(flag[0])

    # the window ------------------------------------------------------
    def window(self, seconds: float) -> dict:
        torch = self.torch
        self.sync()
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()
        self.wait_s = 0.0
        syncs0 = self.host_syncs()
        jobs, job_s = [], []
        cpu0 = time.process_time()
        t_wall = time.time()
        t0 = time.perf_counter()
        k = 0
        while True:
            k += 1
            t = time.perf_counter()
            counts, kept = self._job(k, self.cell.job_shots, keep=True)
            kept.move_to_host()
            jobs.append((counts, kept))
            job_s.append(time.perf_counter() - t)
            if not self._go_on(time.perf_counter() - t0 < seconds):
                break
        self.sync()
        t1 = time.perf_counter()
        cpu_s = time.process_time() - cpu0
        # the peak of the whole run: set-up, the warm job and the window
        peak = (int(torch.cuda.max_memory_allocated(self.slot.device))
                if self.device == "cuda" else None)
        self.jobs = jobs
        return {"seconds": t1 - t0, "start_wall": t_wall, "jobs": len(jobs),
                "shots": len(jobs) * self.cell.job_shots,
                "chunks": len(jobs) * (self.cell.job_shots // self.cell.batch),
                "host_syncs": self.host_syncs() - syncs0,
                "wait_s": self.wait_s, "job_s": job_s, "cpu_s": cpu_s,
                "memory_peak_bytes": peak}

    # the passes of a traced run ----------------------------------------
    def layer_pass(self) -> dict:
        from portbench.spans import EventSpans

        shots = LAYER_CHUNKS * self.cell.batch
        spans = EventSpans()
        # CUDA events time the card alone: on the CPU the pass has no spans
        with (spans.installed(self.slot) if self.device == "cuda"
              else contextlib.nullcontext()):
            counts, _ = self._job(PASS_INDEX, shots)
        self.sync()
        per_card = shots // self.cell.chips
        return {"shots": per_card,
                "seconds": spans.seconds() if self.device == "cuda" else None,
                "iters_x": counts["nIterAccX"] // self.cell.chips,
                "iters_z": counts["nIterAccZ"] // self.cell.chips}

    def trace_pass(self) -> dict:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from portbench.spans import AnnotatedSpans

        shots = TRACE_CHUNKS * self.cell.batch
        acts = [ProfilerActivity.CPU]
        if self.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        tmp = tempfile.mkdtemp(prefix="portbench_trace_")
        try:
            with AnnotatedSpans().installed(self.slot), \
                    profile(activities=acts) as prof:
                t0 = time.perf_counter()
                self._job(PASS_INDEX + 1, shots)
                self.sync()
                window_s = time.perf_counter() - t0
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            events = yardstick.trace_events(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        busy = yardstick.union_length(yardstick.device_intervals(events))
        return {"shots": shots // self.cell.chips,
                "chunks": TRACE_CHUNKS, "window_s": window_s,
                "busy_s": busy * 1e-6,
                "kernels": sum(e["cat"] == "kernel" for e in events),
                "device_ops": yardstick.top_device_ops(events),
                "idle_gaps": yardstick.idle_gaps_by_host(events)}

    # the check -------------------------------------------------------
    def tasks(self):
        """One check task per kept chunk, on the host, and each job's
        counters with this rank's sums of its chunks."""
        cell, conf = self.cell, self.cell.config
        slot = self.slot
        tile = slot.tile
        tpd = slot.batch // tile
        tpc = cell.batch // tile
        first_slot = self.pipe.mesh.first if self.pipe.mesh is not None else 0
        chk = conf["check"]
        out, jobs = [], []
        for counts, kept in self.jobs:
            host = kept.to_host()
            sample = kept.rows.numpy()
            rng = np.random.default_rng([self.seed, kept.job, 3])
            osd_calls = {}
            for side, calls in host["osd"].items():
                osd_calls[side] = []
                for call in calls:
                    rows = call[0].shape[0]
                    pick = np.sort(rng.choice(rows, size=min(
                        rows, int(chk["osd_shots_per_job"])), replace=False))
                    osd_calls[side].append(tuple(a[pick] for a in call))
            out.append({
                "job": kept.job, "Hx": str(cell.path(conf["code"]["Hx"])),
                "Hz": str(cell.path(conf["code"]["Hz"])),
                "seed": self.seed, "p_index": kept.job, "p": cell.p,
                "tile": tile, "n_tiles": tpd,
                "first_tile": kept.chunk * tpc + first_slot * tpd,
                "channel": host["channel"],
                "sample": sample,
                "decoder": dict(conf["decoder"], eps=float(
                    conf["decoder"].get("eps", 1e-6))),
                "decode": host["decode"],
                "osd_order": int(conf["osd_order"]), "osd": osd_calls,
                "classify": host["classify"]})
            jobs.append({"job": kept.job, "totals": counts,
                         "sums": host["sums"], "valid": host["valid"]})
        return out, jobs

    def check(self, ranks_on_host: int) -> dict:
        """The kept chunks against the reference, with this rank's counter
        sums and the jobs' reported counters."""
        t = time.perf_counter()
        tasks, jobs = self.tasks()
        results = check.run_tasks(
            tasks, check.workers_available(ranks_on_host))
        return {"results": results, "seconds": time.perf_counter() - t,
                "jobs": jobs}


def merge_jobs(per_rank: List[List[dict]]) -> List[dict]:
    """Each job's reported counters (rank 0's) with the counter sums and
    valid shots of all ranks added up."""
    out = []
    for rows in zip(*per_rank):
        sums = {k: sum(r["sums"][k] for r in rows) for k in check.COUNTERS}
        out.append({"totals": rows[0]["totals"], "sums": sums,
                    "valid": sum(r["valid"] for r in rows)})
    return out


def load_reader(root: Path, name: str):
    path = root / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def rank_part(cell: Cell, seed: int, seconds: float, trace: bool,
              device: str = "cuda", control: bool = False,
              ranks_on_host: int = 1,
              before: Optional[Dict[str, float]] = None) -> dict:
    """Everything one process measures and checks, as plain data;
    `before` are the set-up's parts timed before the session."""
    s = Session(cell, seed, device=device, control=control)
    s.parts.update(before or {})
    s.setup()
    win = s.window(seconds)
    part = {"rank": s.rank, "world": s.world, "seed": s.seed,
            "setup_parts": s.parts, "window": win, "device": device}
    if trace:
        part["layer"] = s.layer_pass()
        part["trace"] = s.trace_pass()
    part["check"] = s.check(ranks_on_host)
    part["forbidden"] = forbidden_modules()
    part["shapes"] = {"edges_x": int((s.Hz % 2).sum()),
                      "edges_z": int((s.Hx % 2).sum())}
    if device == "cuda":
        import torch
        part["device_kind"] = torch.cuda.get_device_name(s.slot.device)
    return part


def result(cell: Cell, parts: List[dict], t_start: float,
           trace: bool) -> dict:
    """The result line of a run from its processes' parts (rank order)."""
    conf = cell.config
    lead = parts[0]
    win = [p["window"] for p in parts]
    window_s = max(w["seconds"] for w in win)
    shots = lead["window"]["shots"]
    setup_s = max(w["start_wall"] for w in win) - t_start
    jobs = merge_jobs([p["check"]["jobs"] for p in parts])
    results = [r for p in parts for r in p["check"]["results"]]
    nums = check.numbers(results, jobs, cell.job_shots,
                         int(conf["decoder"]["iterations"]),
                         int(conf["osd_order"]) >= 0)
    verdict = check.verdict(nums, conf["check"]["limits"])
    lost = sum(abs(j["valid"] - cell.job_shots) for j in jobs)
    rate = shots / window_s
    # a run on the CPU reports no number under a metric's name
    on_card = lead["device"] == "cuda"
    metrics: Dict[str, dict] = {}
    if on_card and not trace:
        values = {"setup_s": setup_s, "shots_per_s": rate,
                  "shots_per_s_4card": rate}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    elif on_card:
        obs = {"cell": {"name": cell.name, "chips": cell.chips,
                        "decoder": conf["decoder"]},
               "yardstick": yardstick, "ranks": parts,
               "window": lead["window"], "layer": lead["layer"],
               "trace": lead["trace"], "shapes": lead["shapes"]}
        for m in cell.per_layer:
            value = load_reader(cell.root, m["name"])(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": lead.get("device_kind"),
              "count": len(parts) if cell.chips > 1 else 1,
              "memory_peak_bytes": max(p["window"]["memory_peak_bytes"]
                                       or 0 for p in parts)}
    out = {"correct": all(v["ok"] for v in verdict.values()),
           "attempted": shots, "failed": lost, "metrics": metrics,
           "device": device}
    if trace:
        tr = [p["trace"] for p in parts]
        device["busy_s"] = sum(t["busy_s"] for t in tr) / len(tr)
        device["window_s"] = sum(t["window_s"] for t in tr) / len(tr)
        out["breakdown"] = {"device_ops": lead["trace"]["device_ops"],
                            "idle_gaps": lead["trace"]["idle_gaps"]}
    out["check"] = {k: {"value": v["value"], "limit": v["limit"]}
                    for k, v in verdict.items()}
    return out


def info_lines(cell: Cell, parts: List[dict], t_start: float) -> List[str]:
    lead = parts[0]
    win = [p["window"] for p in parts]
    lines = [f"# cell {cell.name}: {cell.config_name} x {cell.traffic_name}, "
             f"{cell.chips} chip(s), p {cell.p}, jobs of {cell.job_shots} "
             f"shots, {cell.batch} shots a chunk, seed {lead.get('seed')}",
             f"# card {yardstick.card_line()}",
             f"# host {yardstick.host_cpu()}",
             "# setup " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    lead["setup_parts"].items())
             + f", to the window {max(w['start_wall'] for w in win) - t_start:.3f} s",
             "# window " + ", ".join(
                 f"rank {p['rank']}: {p['window']['jobs']} jobs "
                 f"{p['window']['seconds']:.3f} s (a job "
                 f"{min(p['window']['job_s']):.3f}-"
                 f"{max(p['window']['job_s']):.3f} s, in order "
                 + " ".join(f"{x:.3f}" for x in p['window']['job_s']) + ")"
                 for p in parts),
             "# window CPU " + ", ".join(
                 f"rank {p['rank']}: the process used "
                 f"{p['window']['cpu_s']:.3f} s" for p in parts),
             "# check " + ", ".join(
                 f"rank {p['rank']}: {len(rs)} chunks, "
                 f"{sum(r['shots'] for r in rs)} channel shots, "
                 f"{sum(r['pairs'] for r in rs)} decode pairs, "
                 f"{sum(r['osd_shots'] for r in rs)} OSD shots, "
                 f"{sum(r['classify_calls'] for r in rs)} classifications, "
                 f"{p['check']['seconds']:.3f} s"
                 for p in parts for rs in [p['check']['results']])]
    return lines


def print_result(cell: Cell, parts: List[dict], t_start: float,
                 trace: bool) -> int:
    """Print the info lines, the compared numbers (standard error) and the
    result line; 0, or 4 when a forbidden module was loaded."""
    found = sorted({m for p in parts for m in p["forbidden"]}
                   | set(forbidden_modules()))
    if found:
        print(f"portbench: modules loaded that no run may hold: {found}",
              file=sys.stderr)
        return 4
    res = result(cell, parts, t_start, trace)
    for line in info_lines(cell, parts, t_start):
        print(line)
    for k, v in res["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
