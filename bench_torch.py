#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port (`qldpcsim_torch`): warm decoded
shots/s of its main paths on the card, each beside its counters, a check
against the plain versions on the CPU and per-layer numbers. The twin of
`bench.py` and `benchmarks/run_configs.py`, which run the JAX package.

    python3 bench_torch.py                          # the flagship
    python3 bench_torch.py --config all --out res.jsonl
    python3 bench_torch.py --config config5_B --config config5_F
    python3 bench_torch.py --device cpu --config flagship --shots 8192

Configurations (`--config`, repeatable, run in the order given; `all`):
  flagship        lp118_0, MS-L-50 (beta 0.75), p 0.05, 4,194,304 shots
  flagship_4card  the flagship on 4 cards, one process each, 4096 shots a
                  card and chunk, 16,777,216 shots (`--chips` other counts)
  config5_B/_F    lp118_0, BP-F-99 + OSD-2, p 0.03, on kernel B / kernel F
                  (QLDPC_QC_STACKED=1)
  msf50_B/_F      lp118_0, MS-F-50, p 0.05, on kernel B / kernel F
  config4         the Tanner code, MS-S-30, p 0.01 (4,194,304 shots) and
                  0.1 (1,048,576) on one pipeline, as `simulate` runs them
  nonqc           lp118_0 with its columns permuted, MS-L-50, p 0.05
  steane_auto/_gh Steane, MS-L-50, p 0.05, impl auto / gh (kernel E)
  configs_1_3     Shor BP-F-99, Steane MS-L-50, bicycle BF-50 and NG, as
                  `benchmarks/run_configs.py` runs them

It prints one JSON line per configuration and p (`qldpcsim_torch/utils/
bench.py` says what each field holds and how it is measured) and exits 1
when a line is not `correct`, after printing it. `--device cuda` (the
default) raises when torch sees no card; `--device cpu` runs the plain
PyTorch versions, with every device number None. The kernels are built
from the sources beside this script on first use.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    sys.path.insert(0, HERE)
    from qldpcsim_torch.utils import bench

    return bench.main(argv, script=os.path.abspath(__file__))


if __name__ == "__main__":
    sys.exit(main())
