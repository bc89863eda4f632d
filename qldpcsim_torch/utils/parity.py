"""Statistical qBLER parity of the port against reference semantics
(`parity_torch.py`): the twin of the JAX package's `benchmarks/parity.py`
in its `--oracle native` mode, with the same names, rows and test.

The accuracy bar (BASELINE.md) is "qBLER curves match the reference within
Monte-Carlo confidence bounds". For each row of `BASELINE.json` configs 1-5
two independent pipelines estimate qBLER = 1 - (exact + degen) / shots:

  * the engine: the port's `simulate_p` (threefry channel, the kernels on
    the card, or their plain versions on the CPU when asked);
  * the oracle, on the host: the channel drawn with numpy at the
    reference's marginals (`sample_channel`: X w.p. 2p/3, Z w.p. 2p/3, both
    w.p. p/3), decoded by the native C++ core `csrc/gf2core.cpp` through
    `gf2/native.py` (MS: the reference's min-sum; BP: the reference's
    float64 numerics; OSD on the shots that did not converge) and, for BF
    and NG, by per-shot numpy decoders (`bf_decode`, `ng_decode`), and
    classified by the reference's event tests.

The oracle shares no code with the engine's decode path. The test is a
two-proportion z-test, |q_new - q_ref| <= Z * sqrt(pv * (1/N + 1/M)) with
the pooled variance pv and Z = 4; the shot counts keep every bound at or
below 0.02.

There is no fallback: the MS and BP oracles raise when the native core is
unavailable (no g++, or `QLDPC_NATIVE=0`), `device="cuda"` raises without a
card, and `oracle_mode="reference"` (the JAX harness's literal reference
decoders) raises a ValueError.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from qldpcsim_torch.codes import get_code
from qldpcsim_torch.decoders.common import layerize
from qldpcsim_torch.engine.montecarlo import ShotPipeline, SimConfig, simulate_p
from qldpcsim_torch.gf2 import native
from qldpcsim_torch.ops import _build
from qldpcsim_torch.utils.bench import card_line

Z = 4.0

REFERENCE_WHY = (
    "oracle mode 'reference' decodes with the literal reference simulator, "
    "imported from its own source tree, which is not part of this "
    "repository; the native oracle holds the same semantics")


@dataclasses.dataclass(frozen=True)
class Row:
    """One row of the harness: a code, a decoder and p, with the engine's
    shots and the oracle's (at scale 1)."""

    name: str
    code: str
    p: float
    shots_new: int
    shots_ref: int
    dec_type: str
    iters: int
    schedule: str
    osd_order: int = -1
    bf_residual: str = "mod2"


# BASELINE.json configs 1-5 (`benchmarks/parity.py:264-275`, the native
# oracle counts): every 4-sigma bound <= 0.02 at scale 1 (worst case
# bicycle BF, qBLER ~0.4).
ROWS = (
    Row("1_shor_bp_p01", "shor", 0.01, 100000, 20000, "BP", 99, "F"),
    Row("1_shor_bp_p05", "shor", 0.05, 100000, 20000, "BP", 99, "F"),
    Row("2_steane_nms_layered", "steane", 0.05, 100000, 20000, "MS", 50,
        "L"),
    Row("3_bicycle_bf", "bicycle", 0.02, 100000, 20000, "BF", 50, "F"),
    Row("3_bicycle_bf_refres", "bicycle", 0.02, 100000, 20000, "BF", 50,
        "F", bf_residual="bool"),
    Row("3_bicycle_ng", "bicycle", 0.01, 100000, 20000, "NG", 0, "F"),
    Row("4_tanner_ms_serial", "tanner", 0.04, 65536, 10000, "MS", 30, "S"),
    Row("5_lp04_bp_osd2", "lp04_0", 0.04, 100000, 20000, "BP", 30, "F",
        osd_order=2),
    Row("5_lp118_bp_osd2", "lp118_0", 0.05, 100000, 10000, "BP", 30, "F",
        osd_order=2),
    # the reference's own OSD wiring is MS-only: covered too
    Row("5b_lp118_ms_osd2", "lp118_0", 0.05, 100000, 10000, "MS", 30, "F",
        osd_order=2),
)


def sample_channel(code, p, shots, seed):
    """The oracle's channel, drawn with numpy at the reference's marginals:
    (Hx, Hz, err_x, err_z, sy_z, sy_x)."""
    Hx = np.asarray(code.Hx) % 2
    Hz = np.asarray(code.Hz) % 2
    n = Hx.shape[1]
    rng = np.random.default_rng(seed + 7919)
    u = rng.random((shots, n))
    err_x = u < 2 * p / 3
    err_z = (u >= p / 3) & (u < p)
    sy_z = (err_x.astype(np.int64) @ Hz.T.astype(np.int64)) % 2
    sy_x = (err_z.astype(np.int64) @ Hx.T.astype(np.int64)) % 2
    return Hx, Hz, err_x, err_z, sy_z, sy_x


def bf_decode(H, syndrome, max_iter=50, residual="mod2"):
    """Bit-flipping of one shot, the reference's semantics: flip every
    variable with more than half its checks unsatisfied, until the residual
    is zero. residual="bool" is the reference simulator's residual (a check
    counts when any of its variables is set, not their parity); "mod2" the
    parity. Returns (e_hat int8, iterations, converged)."""
    H = np.asarray(H).astype(np.int64)
    n = H.shape[1]
    deg = H.sum(axis=0)
    e = np.zeros(n, dtype=bool)
    syndrome = np.asarray(syndrome).astype(np.int64)
    r = syndrome.copy()
    for it in range(max_iter):
        nuc = r @ H
        e = e ^ (nuc > deg / 2.0)
        if residual == "bool":
            r = (H @ e > 0).astype(np.int64) ^ syndrome
        else:
            r = ((H @ e) % 2) ^ syndrome
        if r.sum() == 0:
            return e.astype(np.int8), it + 1, True
    return e.astype(np.int8), max_iter, False


def ng_decode(H, syndrome):
    """Naive-greedy of one shot, the reference's semantics: flip the
    variable in the most failing checks (the first on ties), up to 2n
    steps; a step with no positive score ends it (and counts). Returns
    (e_hat int8, steps)."""
    H = np.asarray(H).astype(np.int64)
    n = H.shape[1]
    res = np.asarray(syndrome).astype(np.int64).copy()
    e = np.zeros(n, np.int8)
    steps = 0
    while res.sum() > 0 and steps < 2 * n:
        steps += 1
        scores = res @ H
        if scores.max() == 0:
            break
        v = int(np.argmax(scores))
        e[v] ^= 1
        res = res ^ H[:, v]
    return e, steps


def require_native():
    """Raises when the native core is unavailable, saying why."""
    if native.get_lib() is None:
        why = ("QLDPC_NATIVE=0 in the environment"
               if os.environ.get("QLDPC_NATIVE", "1") == "0"
               else native._FAILED or "it could not be built")
        raise RuntimeError("parity: the MS and BP oracles decode with the "
                           f"native GF(2) core (csrc/gf2core.cpp), which is "
                           f"unavailable: {why}")


def _decode_side_batch(H, syn, p, dec_type, iters, layers, osd_order,
                       bf_residual):
    """All shots of one side through the oracle decoders -> (B, n) int8."""
    if dec_type in ("MS", "BP"):
        require_native()
        decode = (native.ms_decode_native if dec_type == "MS"
                  else native.bp_decode_native)
        e, _it, conv, post = decode(H, syn, p / 3, iters, layers, threads=0)
        if osd_order < 0:
            return e
        fails = np.nonzero(~conv)[0]
        if fails.size == 0:
            return e
        e = e.copy()
        e[fails] = native.osd_decode_native(
            H, e[fails], syn[fails], post[fails].astype(np.float64),
            osd_order)
        return e
    es = np.zeros((syn.shape[0], H.shape[1]), np.int8)
    for s in range(syn.shape[0]):
        if dec_type == "BF":
            e = bf_decode(H, syn[s], residual=bf_residual)[0]
        elif dec_type == "NG":
            e = ng_decode(H, syn[s])[0]
        else:
            raise ValueError(dec_type)
        es[s] = np.asarray(e, np.int8) % 2
    return es


def oracle_qbler(code, p, shots, dec_type, iters, schedule, osd_order, seed,
                 bf_residual="mod2", oracle_mode="native"):
    """qBLER of the reference-semantics pipeline on the host's oracle
    decoders."""
    if oracle_mode != "native":
        raise ValueError(f"parity: {REFERENCE_WHY}")
    Hx, Hz, err_x, err_z, sy_z, sy_x = sample_channel(code, p, shots, seed)
    serial = schedule == "S"
    if schedule == "F":
        layers_x = [np.arange(Hz.shape[0])]
        layers_z = [np.arange(Hx.shape[0])]
    else:
        layers_x = layerize(Hz, serial=serial)
        layers_z = layerize(Hx, serial=serial)
    ex = _decode_side_batch(Hz, sy_z, p, dec_type, iters, layers_x,
                            osd_order, bf_residual)
    ez = _decode_side_batch(Hx, sy_x, p, dec_type, iters, layers_z,
                            osd_order, bf_residual)
    # the reference's event classification, vectorized
    rx = err_x.astype(np.int64) ^ (ex.astype(np.int64) % 2)
    rz = err_z.astype(np.int64) ^ (ez.astype(np.int64) % 2)
    exact = (rx == 0).all(axis=1) & (rz == 0).all(axis=1)
    degen = (~exact) \
        & (Hz.astype(np.int64) @ rx.T == 0).all(axis=0) \
        & (Hx.astype(np.int64) @ rz.T == 0).all(axis=0)
    good = int((exact | degen).sum())
    return 1.0 - good / shots


def engine_qbler(code, p, shots, dec_type, iters, schedule, osd_order, seed,
                 bf_residual="mod2", device="cuda"):
    """(qBLER, warm shots/s) of the port's `simulate_p` on `device`; the
    rate is NaN for a run of one chunk."""
    Hx, Hz = np.asarray(code.Hx) % 2, np.asarray(code.Hz) % 2
    cfg = SimConfig(shots=shots, dec_type=dec_type, dec_iterations=iters,
                    dec_schedule=schedule, osd_order=osd_order, rng_seed=seed,
                    bf_residual=bf_residual, device=device)
    r = simulate_p(Hx, Hz, p, cfg, pipeline=ShotPipeline(Hx, Hz, cfg))
    return r.qbler, r.shots_per_s_warm


def run_one(name, code_name, p, n_new, n_ref, dec_type, iters, schedule,
            osd_order=-1, seed=0, bf_residual="mod2", device="cuda"):
    """One row: both estimates, the z-test, and where and how long each
    side ran."""
    if dec_type in ("MS", "BP"):   # before the engine's run
        require_native()
    code = get_code(code_name)
    t0 = time.perf_counter()
    q_new, sps = engine_qbler(code, p, n_new, dec_type, iters, schedule,
                              osd_order, seed, bf_residual, device)
    t1 = time.perf_counter()
    q_ref = oracle_qbler(code, p, n_ref, dec_type, iters, schedule,
                         osd_order, seed, bf_residual)
    t2 = time.perf_counter()
    pool = (q_new * n_new + q_ref * n_ref) / (n_new + n_ref)
    var = max(pool * (1 - pool), 1.0 / (n_new + n_ref))
    bound = Z * math.sqrt(var * (1.0 / n_new + 1.0 / n_ref))
    return {
        "config": name, "code": code_name, "decoder": dec_type,
        "schedule": schedule, "osd": osd_order, "p": p,
        "oracle": "native", "device": device,
        "qBLER_new": round(q_new, 5), "shots_new": n_new,
        "qBLER_ref": round(q_ref, 5), "shots_ref": n_ref,
        "bound": round(bound, 5),
        "pass": bool(abs(q_new - q_ref) <= bound),
        "engine_shots_per_s": None if sps != sps else round(sps, 1),
        "oracle_shots_per_s": round(n_ref / max(t2 - t1, 1e-9), 2),
        "seconds_engine": t1 - t0, "seconds_oracle": t2 - t1,
        "card": card_line() if device == "cuda" else None,
        **({"bf_residual": bf_residual} if dec_type == "BF" else {}),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="parity_torch.py",
        description="qBLER of the port against a reference-semantics "
                    "oracle on the host, a two-proportion z-test at "
                    f"{Z} sigma: one JSON line per row.")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale factor on oracle shot counts")
    ap.add_argument("--oracle", choices=["native", "reference"],
                    default="native",
                    help="native (the only mode here; reference raises)")
    ap.add_argument("--only", default=None,
                    help="comma-separated row-name prefixes to run")
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda runs the kernels and raises without a card; "
                         "cpu runs their plain versions")
    ap.add_argument("--engine-shots", type=int, default=None,
                    help="engine shots of every row (default: each row's)")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the rows; 0 when every row is within the bound, else 1."""
    args = build_parser().parse_args(argv)
    if args.oracle != "native":
        raise ValueError(f"parity: {REFERENCE_WHY}")
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("parity: --device cuda but torch sees no "
                               "CUDA device; --device cpu runs the plain "
                               "versions")
        _build.load_all()   # one nvcc per source, all at once
    prefixes = (tuple(x.strip() for x in args.only.split(","))
                if args.only else None)
    rows = []
    for row in ROWS:
        if prefixes and not row.name.startswith(prefixes):
            continue
        line = run_one(
            row.name, row.code, row.p,
            args.engine_shots or row.shots_new,
            max(64, int(row.shots_ref * args.scale)), row.dec_type,
            row.iters, row.schedule, osd_order=row.osd_order,
            bf_residual=row.bf_residual, device=args.device)
        print(json.dumps(line), flush=True)
        rows.append(line)
    if not rows:
        raise ValueError(f"parity: no row starts with {args.only!r}")
    n_fail = sum(not r["pass"] for r in rows)
    maxb = max(r["bound"] for r in rows)
    print(f"# parity: {len(rows) - n_fail}/{len(rows)} within {Z}-sigma; "
          f"max bound {maxb:.4f}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(r) + "\n" for r in rows))
    return 1 if n_fail else 0
