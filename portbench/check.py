"""The comparison that decides `correct`: what the timed window produced,
against the plain reference (`portbench/reference`), chunk by chunk.

For every job the window kept one chunk (`capture.py`). Each kept chunk is
one task, run in a worker process (`python -m portbench.check`: numpy
alone, one thread each, its tasks and results pickled over its standard
input and output):

  channel     the reference draws the chunk's errors from the seed, the
              job's key branch and the chunk's global tiles, and forms both
              syndromes; a shot counts when either error or either syndrome
              differs from the program's;
  decode      a sample of the chunk's shots (drawn from the seed) is decoded
              again from the reference's syndromes on both sides, by the
              `decode` of the module of `portbench/reference/` that the
              configuration names (`reference.decode`; `decode` without
              it, the flooding and layered schedules); a (shot,
              side) pair counts when the estimate, the iteration count or
              convergence differs; over the pairs that agree and converged,
              the pair's mean relative posterior gap |P - R| / max(|R|, 1)
              is kept;
  osd         a sample of the chunk's decoder-failed shots (in the chunk, or
              in the group-level pass that its records reached) goes through
              the reference's OSD from the program's own OSD inputs (its
              posterior, estimate and syndrome): the stage by itself;
  classify    every classification of the chunk's shots (and of the group
              pass its records reached) is done again from its inputs; the
              gap of the event counters is summed.

The numbers compared are then (`numbers`): channel_bad (shots),
decode_bad_share (pairs), posterior_gap (the median over pairs),
osd_bad (shots), classify_bad (counts) and counters_bad: for every job, the
gap between the counters the program reported and the sum of what its
chunks' classifications and iteration sums counted (over all cards), the
shots counted against the job's shots, and the counter invariants broken.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from portbench import yardstick
from portbench.reference import channel, classify, osd

ROOT = Path(__file__).resolve().parents[1]
COUNTERS = classify.EVENTS + ("nIterAccX", "nIterAccZ")
# the order in which the numbers are printed
ORDER = ("channel_bad", "decode_bad_share", "posterior_gap", "osd_bad",
         "classify_bad", "counters_bad")


@functools.lru_cache(maxsize=None)
def _decoder(name: str):
    """`decode` of the reference module `name` (`portbench/reference/`;
    the harness has checked the name), imported once per process."""
    return importlib.import_module(f"portbench.reference.{name}").decode


@functools.lru_cache(maxsize=4)
def _matrices(hx_path: str, hz_path: str):
    Hx = (np.load(hx_path) % 2).astype(np.uint8)
    Hz = (np.load(hz_path) % 2).astype(np.uint8)
    return Hx, Hz, classify.Classifier(Hx, Hz)


def check_chunk(task: dict) -> dict:
    """One kept chunk against the reference (see the module's docstring)."""
    t0 = time.perf_counter()
    Hx, Hz, cls = _matrices(task["Hx"], task["Hz"])
    n = Hx.shape[1]
    out = {"job": task["job"], "shots": 0, "channel_bad": 0, "pairs": 0,
           "decode_bad": 0, "gaps": [], "osd_shots": 0, "osd_bad": 0,
           "classify_calls": 0, "classify_bad": 0}
    p = task["p"]
    syn = None
    if task["channel"] is not None:
        ex, ez, sz, sx = task["channel"]
        rex, rez = channel.sample(task["seed"], task["p_index"], p, n,
                                  task["tile"], task["first_tile"],
                                  task["n_tiles"])
        rsz, rsx = channel.syndrome(Hz, rex), channel.syndrome(Hx, rez)
        bad = ((ex.astype(np.uint8) != rex).any(1)
               | (ez.astype(np.uint8) != rez).any(1)
               | (sz.astype(np.uint8) != rsz).any(1)
               | (sx.astype(np.uint8) != rsx).any(1))
        out["shots"] = int(rex.shape[0])
        out["channel_bad"] = int(bad.sum())
        syn = {"x": rsz, "z": rsx}
    dec = task["decoder"]
    decode = _decoder(task["reference"])
    sample = task["sample"]
    for side, H in (("x", Hz), ("z", Hx)):
        prog = task["decode"].get(side)
        if prog is None or syn is None:
            continue
        e, it, cv, post = decode(H, syn[side][sample], p, dec["type"],
                                 dec["schedule"], dec["iterations"],
                                 dec["beta"], dec["eps"])
        pe, pit, pcv, ppost = prog
        differ = ((pe.astype(np.uint8) != e).any(1)
                  | (pit.astype(np.int64) != it) | (pcv.astype(bool) != cv))
        out["pairs"] += int(e.shape[0])
        out["decode_bad"] += int(differ.sum())
        agree = ~differ & cv
        rel = np.abs(ppost[agree] - post[agree]) / np.maximum(
            np.abs(post[agree]), np.float32(1.0))
        out["gaps"] += rel.mean(axis=1).tolist() if rel.size else []
    order = task["osd_order"]
    for side, H in (("x", Hz), ("z", Hx)):
        for e_hat, s, post, prog_out in task["osd"].get(side, []):
            if e_hat.shape[0] == 0:
                continue
            ref = osd.osd(H, order, e_hat, s.astype(np.uint8), post)
            out["osd_shots"] += int(e_hat.shape[0])
            out["osd_bad"] += int((ref != prog_out.astype(np.uint8))
                                  .any(1).sum())
    for err_x, err_z, ex_hat, ez_hat, valid, counts in task["classify"]:
        ref = cls.counts(err_x, err_z, ex_hat, ez_hat, valid)
        out["classify_calls"] += 1
        out["classify_bad"] += sum(abs(ref[k] - counts[k]) for k in ref)
    out["seconds"] = time.perf_counter() - t0
    return out


def run_tasks(tasks: Sequence[dict], workers: int) -> List[dict]:
    """`check_chunk` over the tasks, in the tasks' order, in `workers`
    processes of one thread each (in this process when there is one). Task
    i goes to worker i mod workers. Every worker is started and waited for
    here, on every way out, so that no process outlives the call (a pool of
    `multiprocessing` would leave its resource tracker running until this
    process has exited, and for a moment after)."""
    if workers <= 1 or len(tasks) <= 1:
        return [check_chunk(t) for t in tasks]
    n = min(workers, len(tasks))
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    procs, outs = [], []
    try:
        for w in range(n):    # all start (import numpy) before any is fed
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.check"], cwd=str(ROOT),
                env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE))
        for w, proc in enumerate(procs):
            pickle.dump(list(tasks[w::n]), proc.stdin,
                        protocol=pickle.HIGHEST_PROTOCOL)
            proc.stdin.close()
        for w, proc in enumerate(procs):
            data = proc.stdout.read()
            if proc.wait() != 0:
                raise RuntimeError(f"check worker {w} exited with "
                                   f"{proc.returncode}")
            outs.append(pickle.loads(data))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            for pipe in (proc.stdin, proc.stdout):
                with contextlib.suppress(OSError):
                    pipe.close()
    results: List[dict] = [{}] * len(tasks)
    for w, part in enumerate(outs):
        results[w::n] = part
    return results


def workers_available(ranks_on_host: int = 1) -> int:
    """Worker processes for the check: the CPUs this process may use,
    shared among the ranks of the host, one left for the rank itself."""
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:
        n = os.cpu_count() or 1
    return max(1, n // max(1, ranks_on_host) - 1)


def counter_gaps(jobs: Sequence[dict], job_shots: int, iters: int) -> int:
    """counters_bad over the jobs: each job's reported counters against the
    sum of its chunks' (`sums`, over all cards), the shots its
    classifications counted (`valid`) against the job's shots, and its
    broken invariants."""
    bad = 0
    for job in jobs:
        totals, sums = job["totals"], job["sums"]
        bad += sum(abs(int(totals[k]) - int(sums[k])) for k in COUNTERS)
        bad += abs(int(job["valid"]) - job_shots)
        bad += len(yardstick.invariants_broken(totals, job_shots, iters))
    return bad


def numbers(results: Sequence[dict], jobs: Sequence[dict], job_shots: int,
            iters: int, with_osd: bool) -> Dict[str, Optional[float]]:
    """The numbers compared, from the tasks' results and the jobs'
    counters. posterior_gap is None when no pair agreed and converged."""
    pairs = sum(r["pairs"] for r in results)
    gaps = [g for r in results for g in r["gaps"]]
    out = {
        "channel_bad": float(sum(r["channel_bad"] for r in results)),
        "decode_bad_share": (sum(r["decode_bad"] for r in results) / pairs
                             if pairs else None),
        "posterior_gap": float(np.median(gaps)) if gaps else None,
        "classify_bad": float(sum(r["classify_bad"] for r in results)),
        "counters_bad": float(counter_gaps(jobs, job_shots, iters)),
    }
    if with_osd:
        out["osd_bad"] = float(sum(r["osd_bad"] for r in results))
    return {k: out[k] for k in ORDER if k in out}


def verdict(nums: Dict[str, Optional[float]], limits: Dict[str, float]
            ) -> Dict[str, dict]:
    """Each number beside its limit; a number that is missing (None) or
    above its limit fails."""
    return {k: {"value": v, "limit": limits[k],
                "ok": v is not None and v <= limits[k]}
            for k, v in nums.items()}


def _worker() -> int:
    """A worker of `run_tasks`: its tasks from standard input, their
    results to standard output."""
    tasks = pickle.load(sys.stdin.buffer)
    pickle.dump([check_chunk(t) for t in tasks], sys.stdout.buffer,
                protocol=pickle.HIGHEST_PROTOCOL)
    sys.stdout.buffer.flush()
    return 0


if __name__ == "__main__":
    sys.exit(_worker())
