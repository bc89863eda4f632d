"""Command-line front-end (port of `qldpcsim_tpu/cli.py`).

The reference CLI's flags: --Hx --Hz --p --shots --rngSeed --decType
--decIterations --decSchedule --OSDorder, and its extensions --code (the
built-in library), --batch, --mesh, --mesh-p, --execMode, --layerCompat,
--impl, --validateEncoding, --bfResidual, --checkpointDir (resumable
sweeps), --out (JSON lines), --quiet and --profile. Two differ in their
choices: `--device` is `cuda` (the default: the CUDA kernels; without a card
the run raises, it does not move to the CPU) or `cpu` (their plain PyTorch
versions), and `--execMode` is `auto` or `perdevice`, the one sharded mode
(the reference's `shardmap` is a partitioned JAX program).

`--mesh` shards each chunk's shots over the cards this process owns (on the
CPU: one slot per process); `--mesh-p N` runs the p-points N at a time on N
rows of slots. Under a launcher (torchrun, or the same environment set by
hand) the processes join one gloo process group first; rank 0 alone prints
and writes `--out` and the `--profile` trace. Without one, `--mesh` or
`--mesh-p` on the card with more than one card in sight starts the run
again as one process per card (`parallel/launch.py`): slot threads of one
process contend for the host, processes do not. `--batch` keeps its meaning
either way (a chunk over all cards: `--batch 4096*N` gives each of N cards
a 4096-shot chunk), and so do the counters. With `QLDPC_LAUNCH_COUNTS=PATH` in the environment every
rank writes its kernel launches (`ops.launch_counts`) as JSON to
`PATH.<rank>` when the run ends.

    python -m qldpcsim_torch --code lp118_0 --p 0.03 0.05 --shots 65536 \\
        --decType MS --decSchedule L --decIterations 50 --rngSeed 0
    python -m qldpcsim_torch --mesh --code lp118_0 ...     # a process per card
    torchrun --nproc-per-node 2 -m qldpcsim_torch --mesh --code lp118_0 ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="qldpcsim_torch",
        description="Quantum-LDPC depolarizing-channel simulator on PyTorch "
                    "and CUDA (qBLER Monte Carlo for CSS codes).")
    src = parser.add_argument_group("code input")
    src.add_argument("--Hx", help="Path to Hx parity-check matrix (.npy or text).")
    src.add_argument("--Hz", help="Path to Hz parity-check matrix (.npy or text).")
    src.add_argument("--code", help="Built-in code name (shor, steane, bicycle, "
                                    "tanner, lp04_0..3, lp118_0..2) instead of --Hx/--Hz.")
    parser.add_argument("--p", type=float, nargs="+", required=True,
                        help="Depolarizing probability (one or more points).")
    parser.add_argument("--shots", type=int, default=1000,
                        help="Number of Monte Carlo shots.")
    parser.add_argument("--rngSeed", type=int, default=None, help="RNG seed.")
    parser.add_argument("--decType", choices=["NG", "BF", "MS", "BP"], default="MS",
                        help="Decoder type: [NG] Naive Greedy; [BF] Bit-Flipping; "
                             "[MS] Min-Sum; [BP] Belief Propagation.")
    parser.add_argument("--decIterations", type=int, default=99,
                        help="Number of decoding iterations.")
    parser.add_argument("--decSchedule", choices=["F", "L", "S"], default="F",
                        help="Decoder scheduling: [F] flooding; [L] layered; [S] serial.")
    parser.add_argument("--OSDorder", type=int, default=-1,
                        help="Ordered Statistics Decoding order (-1 = disable).")
    ex = parser.add_argument_group("execution")
    ex.add_argument("--batch", type=int, default=0,
                    help="Shots per chunk (0 = auto).")
    ex.add_argument("--mesh", action="store_true",
                    help="Shard each chunk's shots over the cards this "
                         "process owns and over every process of the run "
                         "(counters equal the unsharded run's). With more "
                         "than one card and no launcher it starts one "
                         "process per card.")
    ex.add_argument("--mesh-p", type=int, default=0, metavar="N",
                    help="Run the p-points N at a time on N rows of slots "
                         "(per-p counters equal the serial sweep's).")
    ex.add_argument("--execMode", choices=("auto", "perdevice"),
                    default="auto",
                    help="Sharded execution (with --mesh/--mesh-p): "
                         "perdevice, the one mode: a host thread per local "
                         "slot, counters summed on the host and over "
                         "processes (gloo).")
    ex.add_argument("--layerCompat", action="store_true",
                    help="Reproduce the reference's cross-wired layer derivation.")
    ex.add_argument("--impl",
                    choices=("auto", "edge", "mxu", "seq", "qc", "gh"),
                    default="auto",
                    help="Decoder implementation override: edge (the padded "
                         "edge layout), mxu (incidence products), seq "
                         "(row-sequential), qc (the circulant-lifted "
                         "kernels), gh (the general-H kernel for non-QC "
                         "codes); auto picks by structure.")
    ex.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs the CUDA kernels and raises when torch "
                         "sees no card; cpu runs their plain PyTorch "
                         "versions.")
    ex.add_argument("--validateEncoding", action="store_true",
                    help="Run the full encode->corrupt->extract pipeline "
                         "(GF(2) codeword frames; counters provably equal "
                         "the frame-free channel).")
    ex.add_argument("--bfResidual", choices=("mod2", "bool"), default="mod2",
                    help="BF residual semantics: mod2 (parity, default) or "
                         "bool (the reference simulator's any-overlap "
                         "residual).")
    ex.add_argument("--checkpointDir", default=None,
                    help="Directory for resumable per-p-point counter checkpoints.")
    ex.add_argument("--out", default=None, help="Write results as JSON lines.")
    ex.add_argument("--quiet", action="store_true", help="Suppress progress lines.")
    ex.add_argument("--profile", default=None, metavar="DIR",
                    help="Write a torch.profiler trace of the sweep to DIR "
                         "(Chrome trace format).")
    return parser


def ranks_to_launch(args: argparse.Namespace) -> int:
    """How many processes this command line starts itself as: one per card
    for a sharded run on the card with more than one card in sight and no
    launcher around it; else 0, and it runs here."""
    if not (args.mesh or args.mesh_p) or args.device != "cuda":
        return 0
    from qldpcsim_torch.parallel.launch import launched

    if launched():
        return 0
    import torch

    n = torch.cuda.device_count()
    return n if n > 1 else 0


def main(argv: Optional[list] = None) -> int:
    args = build_parser().parse_args(argv)
    n_ranks = ranks_to_launch(args)
    if n_ranks:
        from qldpcsim_torch.parallel.launch import launch_local

        return launch_local(n_ranks,
                            sys.argv[1:] if argv is None else list(argv))
    sharded = bool(args.mesh or args.mesh_p)
    lead = True  # several processes: rank 0 alone prints and writes --out
    if sharded:
        from qldpcsim_torch.parallel.mesh import multihost_init, world

        multihost_init()
        lead = world()[0] == 0

    if args.code:
        from qldpcsim_torch.codes import get_code

        code = get_code(args.code)
        Hx, Hz = np.asarray(code.Hx), np.asarray(code.Hz)
    elif args.Hx and args.Hz:
        from qldpcsim_torch.codes.loader import load_matrix

        Hx, Hz = load_matrix(args.Hx), load_matrix(args.Hz)
    else:
        print("error: provide either --code or both --Hx and --Hz", file=sys.stderr)
        return 2

    if lead:
        print("\n   Command line arguments:")
        print(args)
        print("")

    p = np.asarray(args.p, dtype=np.float64)
    if p.size == 0 or p.min() < 0.0 or p.max() > 1.0:
        print("error: --p values must lie in [0, 1]", file=sys.stderr)
        return 2

    from qldpcsim_torch.engine.montecarlo import (
        ShotPipeline, SimConfig, default_mesh, simulate_p, simulate_sweep)
    from qldpcsim_torch.engine.results import format_results_table
    from qldpcsim_torch.utils.profiling import trace_context

    cfg = SimConfig(
        shots=args.shots, dec_type=args.decType, dec_iterations=args.decIterations,
        dec_schedule=args.decSchedule, osd_order=args.OSDorder,
        rng_seed=args.rngSeed, batch_size=args.batch, layer_compat=args.layerCompat,
        bf_residual=args.bfResidual, validate_encoding=args.validateEncoding,
        impl=args.impl, device=args.device,
        mesh=default_mesh(args.device, max(1, args.mesh_p)) if sharded
        else None, mesh_p=args.mesh_p, exec_mode=args.execMode,
        checkpoint_dir=args.checkpointDir, progress=not args.quiet,
    )
    with trace_context("p_sweep", args.profile if lead else None):
        if cfg.mesh_p:
            results = simulate_sweep(Hx, Hz, p, cfg)
        else:
            pipe = ShotPipeline(Hx, Hz, cfg)
            results = [simulate_p(Hx, Hz, pT, cfg, pipeline=pipe, p_index=i)
                       for i, pT in enumerate(p)]

    counts_path = os.environ.get("QLDPC_LAUNCH_COUNTS")
    if counts_path:
        from qldpcsim_torch.ops import launch_counts
        from qldpcsim_torch.parallel.mesh import world

        with open(f"{counts_path}.{world()[0]}", "w") as f:
            json.dump(launch_counts(), f)
    if not lead:
        return 0
    print(format_results_table(results))
    if args.out:
        with open(args.out, "w") as f:
            for r in results:
                f.write(r.to_json() + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
