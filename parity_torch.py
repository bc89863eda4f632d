#!/usr/bin/env python3
"""qBLER parity of the PyTorch/CUDA port (`qldpcsim_torch`) against a
reference-semantics oracle on the host, over `BASELINE.json` configs 1-5:
the twin of the JAX package's `benchmarks/parity.py --oracle native`.

    python3 parity_torch.py --out parity_torch_results.jsonl
    python3 parity_torch.py --only 4_tanner,5b --scale 0.2
    python3 parity_torch.py --device cpu --only 2_steane --engine-shots 512

Each row runs the port's `simulate_p` (the kernels on the card by default;
`--device cpu` runs their plain versions) and the oracle: the channel drawn
with numpy, MS and BP (+ OSD) decoded by the native C++ core
(`csrc/gf2core.cpp`, built with g++ on first use), BF and NG by per-shot
numpy decoders. It prints one JSON line per row on stdout, then
`# parity: k/n within 4.0-sigma; max bound ...` on stderr, and exits 1 when
a row is outside its bound. `--scale` scales the oracle's shots,
`--engine-shots` overrides the engine's; `--only` takes row-name prefixes.
`qldpcsim_torch/utils/parity.py` holds the logic.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    sys.path.insert(0, HERE)
    from qldpcsim_torch.utils import parity

    return parity.main(argv)


if __name__ == "__main__":
    sys.exit(main())
