#!/usr/bin/env python3
"""One rank of a benchmark cell over several cards, started by
`portbench/run.py` through the program's launcher (which sets MASTER_ADDR,
MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK and LOCAL_WORLD_SIZE). It joins
the gloo process group, runs its part of the cell and writes it as JSON to
`OUT/part.RANK.json`; it prints nothing on standard output.

`--device cpu` runs the program's plain versions on the CPU (tests only);
`--control` builds the pipeline as the configuration's control
(`portbench/readings.py` only, never a benchmark run).
"""

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/rank.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    root = Path(args.root)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import harness
    from qldpcsim_torch.parallel.mesh import multihost_init

    cell = harness.load_cell(root, args.workload)
    harness.cache_environment(root)
    multihost_init()
    part = harness.rank_part(cell, args.seed, args.seconds, bool(args.trace),
                             device=args.device, control=args.control,
                             ranks_on_host=cell.chips)
    with open(os.path.join(args.out, f"part.{part['rank']}.json"), "w") as f:
        json.dump(part, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
