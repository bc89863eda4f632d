#!/usr/bin/env python3
"""Run one cell of the benchmark of `qldpcsim_torch` (`BENCHMARK.json`).

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. Prints a few lines on the run (card, host,
set-up's parts, window, check), then, as the last line, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics,
or with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and last `check`, each number compared with its limit (also
the last lines of standard error). Exits non-zero without a result when
torch sees no card or fewer than the cell asks for, when the program is
not beside this folder, or when a module of JAX or of the JAX package was
loaded. A cell on several cards runs one process per card
(`portbench/rank.py`, started through the program's launcher).
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(code: int, why: str) -> int:
    print(f"portbench: {why}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse(argv)
    if args.seed < 0:
        return fail(2, f"--seed must be non-negative, got {args.seed}")
    sys.path.insert(0, str(ROOT))
    from portbench import harness

    try:
        cell = harness.load_cell(ROOT, args.workload)
    except (OSError, KeyError, ValueError, harness.CellError) as exc:
        return fail(2, f"cannot load workload {args.workload!r}: {exc!r}")
    harness.cache_environment(ROOT)
    t = time.time()
    import torch

    if not torch.cuda.is_available():
        return fail(3, "torch sees no CUDA device; this benchmark runs on "
                       "the card only")
    if torch.cuda.device_count() < cell.chips:
        return fail(3, f"{cell.name} needs {cell.chips} cards, torch sees "
                       f"{torch.cuda.device_count()}")
    if not (ROOT / harness.PROGRAM / "__init__.py").is_file():
        return fail(2, f"the program {harness.PROGRAM} is not in {ROOT}")
    before = {"start_s": t - T_START, "torch_s": time.time() - t}
    if cell.chips == 1:
        torch.zeros(1, device="cuda")   # the card's context
        before["context_s"] = time.time() - t - before["torch_s"]
        part = harness.rank_part(cell, args.seed, args.seconds,
                                 bool(args.trace), before=before)
        return harness.print_result(cell, [part], T_START, bool(args.trace))
    from qldpcsim_torch.parallel.launch import launch_local

    with tempfile.TemporaryDirectory(prefix="portbench_") as tmp:
        rank_argv = ["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace",
                     str(args.trace), "--out", tmp, "--root", str(ROOT)]
        rc = launch_local(cell.chips, rank_argv,
                          prog=(str(ROOT / "portbench" / "rank.py"),))
        if rc != 0:
            return fail(rc if rc > 0 else 1, f"a rank failed with {rc}")
        parts = []
        for r in range(cell.chips):
            with open(os.path.join(tmp, f"part.{r}.json")) as f:
                parts.append(json.load(f))
    return harness.print_result(cell, parts, T_START, bool(args.trace))


if __name__ == "__main__":
    sys.exit(main())
