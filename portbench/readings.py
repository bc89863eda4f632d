#!/usr/bin/env python3
"""The readings that the check's limits are set from, for one cell: windows
of the cell's own load on many seeds, each checked as a run checks it,
first with the pipeline as the configuration states it, then with the
configuration's control (the program's lower-precision path, `control` in
the configuration file). A single-card cell reads every seed in one
process; a cell over several cards starts its ranks (`portbench/rank.py`)
once per seed. One JSON line per seed on standard output: the numbers
compared, the window's rate and jobs.

    python3 portbench/readings.py --workload NAME --seconds S \
        --seeds 11 12 ... --control-seeds 21 22 23

Not part of a benchmark run; run it on the card when a limit is set.
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _one_card(cell, seeds, seconds, control, device):
    """(seed, results, jobs, rate, check seconds) per seed, one process."""
    from portbench import harness

    s = harness.Session(cell, seeds[0], device=device, control=control)
    s.setup()
    for seed in seeds:
        s.reseed(seed)
        win = s.window(seconds)
        chk = s.check(1)
        yield (seed, chk["results"], harness.merge_jobs([chk["jobs"]]),
               win["shots"] / win["seconds"], chk["seconds"])


def _ranks(cell, seeds, seconds, control, device):
    """The same, the cell's ranks started anew for every seed."""
    from portbench import harness
    from qldpcsim_torch.parallel.launch import launch_local

    for seed in seeds:
        with tempfile.TemporaryDirectory(prefix="portbench_readings_") as tmp:
            argv = ["--workload", cell.name, "--seed", str(seed),
                    "--seconds", str(seconds), "--out", tmp,
                    "--root", str(ROOT), "--device", device]
            if control:
                argv.append("--control")
            rc = launch_local(cell.chips, argv,
                              prog=(str(ROOT / "portbench" / "rank.py"),))
            if rc != 0:
                raise SystemExit(f"seed {seed}: a rank failed with {rc}")
            parts = []
            for r in range(cell.chips):
                with open(os.path.join(tmp, f"part.{r}.json")) as f:
                    parts.append(json.load(f))
        window_s = max(p["window"]["seconds"] for p in parts)
        yield (seed, [r for p in parts for r in p["check"]["results"]],
               harness.merge_jobs([p["check"]["jobs"] for p in parts]),
               parts[0]["window"]["shots"] / window_s,
               max(p["check"]["seconds"] for p in parts))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import check, harness

    cell = harness.load_cell(ROOT, args.workload)
    harness.cache_environment(ROOT)
    conf = cell.config
    readings = _one_card if cell.chips == 1 else _ranks
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        if not seeds:
            continue
        t = time.perf_counter()
        for seed, results, jobs, rate, check_s in readings(
                cell, seeds, args.seconds, control, args.device):
            nums = check.numbers(results, jobs, cell.job_shots,
                                 int(conf["decoder"]["iterations"]),
                                 int(conf["osd_order"]) >= 0)
            print(json.dumps({
                "workload": cell.name, "seed": seed, "control": control,
                "numbers": nums, "shots_per_s": rate, "jobs": len(jobs),
                "pairs": sum(r["pairs"] for r in results),
                "decode_bad": sum(r["decode_bad"] for r in results),
                "osd_shots": sum(r["osd_shots"] for r in results),
                "check_s": check_s,
                "seconds": time.perf_counter() - t}), flush=True)
            t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
