#!/usr/bin/env python3
"""Time the QC decode kernels (B and F) of one or more checkouts of the
port on one CUDA card, in turns, so that two versions are compared within
one call:

    python3 chip_compare.py ROOT [ROOT ...]    # e.g. parent change change parent

Each ROOT is the root of a checkout (the directory that holds
`qldpcsim_torch/`). For each, in the order given, a process of its own
builds `ms_qc.cu` and `flood_qc.cu` alone, one after the other, into a new
build directory (nvcc seconds each), and times with CUDA events, on the
same seeded syndromes of lp118_0 side X (4096 shots):
  - kernel B, float32: MS-L-50 (the flagship's shape, p = 0.05), MS-F-50,
    BP-F-99 (config 5's shape, p = 0.03);
  - kernel F, float32: MS-F-99 and BP-F-99 at config 5's shape;
  - where the checkout has them: the same with the bf16 state
    (`dtype=torch.bfloat16`), kernel B with the stacked-update writeback
    (`vec=True`) under L and F, and kernel B's shared memory per shot and
    blocks per SM in float32 and bf16.
It prints one JSON line per root, the card's name and power limit, and a
table with each root's values, run by run. Needs a card; exits non-zero
without one.
"""

import json
import os
import subprocess
import sys
import tempfile

SHOTS, SEED, REPS = 4096, 3, 10


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def one(root):
    """The timings of the checkout at `root`, as a dict."""
    import inspect

    import numpy as np
    import torch

    sys.path.insert(0, root)
    from qldpcsim_torch.codes import get_code
    from qldpcsim_torch.decoders import DecoderConfig, build_layers
    from qldpcsim_torch.ops import _build, flood_qc_cuda, ms_qc_cuda
    from qldpcsim_torch.ops.qc import detect_qc

    if os.path.dirname(os.path.dirname(os.path.abspath(
            ms_qc_cuda.__file__))) != os.path.join(root, "qldpcsim_torch"):
        raise RuntimeError(f"qldpcsim_torch was not imported from {root}")
    out = {"root": root}
    for name in ("ms_qc", "flood_qc"):
        _build.load(name)
        out[f"nvcc {name} s"] = round(_build.BUILD_INFO[name][0], 2)
    dev = torch.device("cuda")
    H = np.asarray(get_code("lp118_0").Hz) % 2
    st = detect_qc(H)
    rng = np.random.default_rng(SEED)
    syn = {}
    for p in (0.05, 0.03):
        errs = (rng.random((SHOTS, H.shape[1])) < 2 * p / 3).astype(np.int64)
        syn[p] = torch.as_tensor((errs @ H.T) % 2, dtype=torch.float32,
                                 device=dev)
    has_variants = "dtype" in inspect.signature(
        ms_qc_cuda.make_qc_decoder).parameters

    def decoder(kind, sched, iters, stacked=False, **kw):
        return ms_qc_cuda.make_qc_decoder(
            st, DecoderConfig(dec_type=kind, max_iter=iters, schedule=sched),
            layers=build_layers(H, sched), device=dev, stacked=stacked, **kw)

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(REPS):
            fn()
        e1.record()
        e1.synchronize()
        return round(e0.elapsed_time(e1) / REPS, 4)

    cases = [("B MS-L-50", "MS", "L", 50, 0.05, False),
             ("B MS-F-50", "MS", "F", 50, 0.05, False),
             ("B BP-F-99", "BP", "F", 99, 0.03, False),
             ("F MS-F-99", "MS", "F", 99, 0.03, True),
             ("F BP-F-99", "BP", "F", 99, 0.03, True)]
    variants = [("", {})]
    if has_variants:
        variants.append((" bf16", {"dtype": torch.bfloat16}))
    for suffix, kw in variants:
        for label, kind, sched, iters, p, stacked in cases:
            dec = decoder(kind, sched, iters, stacked, **kw)
            lch = ms_qc_cuda.llr_prior(np.float32(p) / np.float32(3.0))
            if stacked:
                s = syn[p].contiguous()
                out[label + suffix] = ms(
                    lambda: flood_qc_cuda.flood_qc_cuda(dec, s, lch))
            else:
                s = syn[p].T.contiguous()
                out[label + suffix] = ms(
                    lambda: ms_qc_cuda.ms_qc_cuda(dec, s, lch))
                if has_variants and kind == "MS":
                    out[label + suffix + " smem B"] = 4 * (
                        dec.table_words + dec.state_words)
                    out[label + suffix + " blocks/SM"] = \
                        ms_qc_cuda.blocks_per_sm(dec)
    if has_variants:
        lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
        s = syn[0.05].T.contiguous()
        for sched in ("L", "F"):
            dec = decoder("MS", sched, 50, vec=True)
            out[f"B MS-{sched}-50 vec"] = ms(
                lambda: ms_qc_cuda.ms_qc_cuda(dec, s, lch))
    return out


def main(argv):
    if len(argv) == 2 and argv[0] == "--one":
        print(json.dumps(one(os.path.abspath(argv[1]))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("chip_compare: torch sees no CUDA device", file=sys.stderr)
        return 2
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = nvidia_smi_line()
    rows = []
    for root in argv:
        with tempfile.TemporaryDirectory() as tmp:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--one", root],
                capture_output=True, text=True, timeout=900,
                env=dict(os.environ, QLDPC_TORCH_BUILD_DIR=tmp))
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        rows.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    print(smi)
    keys = []
    for row in rows:
        keys += [k for k in row if k != "root" and k not in keys]
    roots = list(dict.fromkeys(argv))
    print("| | " + " | ".join(os.path.abspath(r) for r in roots) + " |")
    for k in keys:
        cells = []
        for root in roots:
            vals = [row[k] for row in rows
                    if row["root"] == os.path.abspath(root) and k in row]
            cells.append(" / ".join(str(v) for v in vals) or "-")
        print(f"| {k} | " + " | ".join(cells) + " |")
    print(json.dumps({"ok": True, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
