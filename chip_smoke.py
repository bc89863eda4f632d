#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`qldpcsim_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. toolchain: Python, torch and CUDA versions, nvcc, the card's name and
     power limit;
  2. build the five CUDA kernels from `qldpcsim_torch/csrc/*.cu` with nvcc,
     one process per source, all at once, with their register counts;
  3. kernel A (threefry depolarizing channel) against its plain PyTorch
     version on the card: the flagship chunk's 64 tiles x 64 x 544 at
     p = 0.01 and 0.05, bit-exact;
  4. kernel B, kind MS (min-sum over a circulant-lifted H), against its
     plain version on the card: 4096 flagship syndromes per side, 50
     iterations, layered and flooding schedules; e_hat, n_iter, converged
     and the posterior bit-exact;
  5. kernel B, kind BP (tanh-product sum-product), against its plain
     version on the card: 4096 syndromes per side at p = 0.03, flooding, 99
     iterations; e_hat, n_iter, converged and the posterior bit-exact;
  6. kernel C (GF(2) elimination of OSD) against its plain version on the
     card: a 256-shot window of lp118_0 column orders, the decoder-failed
     shots of a BP decode at p = 0.05 in the port's reliability order,
     topped up with random orders; tags, pivots and sel bit-exact;
  7. the flagship path: `simulate_p` on lp118_0 (normalized min-sum,
     layered, 50 iterations, p = 0.05, 4096-shot chunks, 65,536 shots) on
     the card, with the launch counts of its kernels, then a CUDA-event
     breakdown of a chunk into channel, decode X, decode Z and classify;
  8. the flagship's first two chunks through the port on the CPU (plain
     versions) against the same chunks on the card: all 9 counters equal;
  9. config 5: `simulate_p` on lp118_0 (BP, flooding, 99 iterations, OSD-2,
     p = 0.03, 4096-shot chunks, 65,536 shots) on the card, with the
     launch counts of its kernels and the shots that reached OSD, then a
     CUDA-event breakdown of a chunk into channel, decode X, decode Z, OSD
     and classify;
 10. config 5's first two chunks on the CPU against the card: both counter
     sets, the shots whose final estimates differ (BP's tanh and log may
     round differently in the last ulp on the two devices), and qBLER
     within 4 sigma;
 11. kernel D, kind MS (serial min-sum over a circulant-lifted H), against
     its plain version on the card, Tanner code, both sides, syndromes from
     the port's channel at p = 0.07: 4096 shots at the cascade head's 4
     iterations, and a 128-shot window at the full 30 iterations on side X
     (the plain version takes ~50 small launches per check row, so its
     depth is cut to keep the phase short); n_iter, converged and e_hat
     equal, the posterior equal by value; the kernel alone is also timed at
     4096 shots and 30 iterations;
 12. kernel D, kind BP: the same comparison;
 13. config 4: `simulate` on the Tanner code files (min-sum, serial, 30
     iterations, p = 0.01, 0.04, 0.07, 0.1, 32,768 shots each, seed 0) on
     the card; per p the counters, qBLER, iterations, warm shots/s,
     launches and lanes per cascade stage; for p = 0.01 and 0.1 a
     CUDA-event breakdown of a chunk, and at p = 0.1 the high-p guard;
     then the same entry point with BP on 2 chunks, which drives kernel D's
     BP kind;
 14. config 4's first chunk at p = 0.04 on the CPU against the card: all 9
     counters equal;
 15. kernel E, kind MS (min-sum over any H with contiguous layers), against
     its plain version on the card, on matrices with no circulant lift:
     lp118_0 with one seeded column permutation on both sides (the
     flagship's code up to a relabelling of qubits), side X, syndromes from
     the port's channel at p = 0.05, layered and flooding, 4096 shots at the
     cascade head's 4 iterations and a 128-shot tail window at the full 50;
     bicycle (73 one-row layers, row weight 18) and a seeded row-irregular
     240 x 544 matrix (row weights 3 to 8), layered, 4096 shots at 4
     iterations; n_iter, converged and e_hat equal, the posterior equal by
     value; the kernel alone is also timed at 4096 shots and 50 iterations,
     and a lone thread per iteration;
 16. kernel E, kind BP: the same comparison;
 17. the non-QC main path: `simulate_p` on the permuted lp118_0 (min-sum,
     layered, 50 iterations, p = 0.05, 4096-shot chunks, 65,536 shots,
     impl "auto") on the card, with its launch counts (kernel E, neither QC
     kernel) and a CUDA-event breakdown of a chunk; its qBLER within 4 sigma
     of the flagship's from phase 7; `simulate` on the same matrices as .npy
     files; and the same path with BP forced onto kernel E on 2 chunks;
 18. the non-QC main path's first two chunks on the CPU (plain version)
     against the card: all 9 counters equal;
 19. the incidence decoders on the same shape: one side of the permuted
     lp118_0 at 4096 shots through `make_decoder` with impl "mxu" and with
     kernel E, min-sum, 50 iterations with the cascade, layered and
     flooding, timed side by side;
 20. configs 1 to 3 at their own sizes on the card: Shor BP-F-99 (p = 0.01,
     0.05; 1000 shots), Steane MS-L-50 (p = 0.01, 0.03, 0.05; 20,000 shots),
     bicycle BF-50 and NG (p = 0.01, 0.03; 5000 shots), each with counters
     and warm shots/s; the counters of Steane, BF and NG equal to a run on
     the CPU; configs 1 and 2 once more with kernel E forced (impl "gh"),
     timed beside the incidence decoder that the routing gives them.

Each kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over the card's 3.35 TB/s and its operations over 67 Top/s
(the float32 rate outside the tensor cores; integer work is counted against
the same rate, the table of peaks having none for it), for the iterations
and columns this run's data needed. No single PyTorch call computes any of
the kernels' functions, so `library_ms` is null throughout.

The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}. Exits non-zero, printing neither, when torch
sees no CUDA device or the package is not beside this script.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

CODE = "lp118_0"
BATCH = 4096
SEED = 0
CROSS_CHUNKS = 2
BREAKDOWN_CHUNKS = 16
# the flagship: min-sum, layered, 50 iterations, p = 0.05
P_POINT = 0.05
MAX_ITER = 50
SCHEDULE = "L"
SHOTS = 16 * BATCH
# config 5: BP, flooding, 99 iterations, OSD-2, p = 0.03
C5_P = 0.03
C5_ITER = 99
C5_SCHEDULE = "F"
C5_ORDER = 2
C5_SHOTS = 16 * BATCH
ELIM_P = 0.05      # the BP decode that fills kernel C's window
ELIM_WINDOW = 256  # the engine's OSD window
# config 4: Tanner code, min-sum, serial, 30 iterations, a p-sweep
C4_FILES = ("data/Hx_T.npy", "data/Hz_T.npy")
C4_P = [0.01, 0.04, 0.07, 0.1]
C4_ITER = 30
C4_SHOTS = 8 * BATCH       # 16 chunks per p until the script grew
C4_CROSS_CHUNKS = 1
C4_BREAKDOWN_CHUNKS = 8
C4_BP_SHOTS = 2 * BATCH   # the BP variant of the sweep (kernel D, kind BP)
SEQ_P = 0.07              # syndromes of the kernel D comparison
SEQ_HEAD_ITER = 4         # the cascade head's depth, at the full batch
SEQ_TAIL_SHOTS = 128      # the last stage's window, at the full depth
# kernel E: the permuted lp118_0 under the flagship's settings
GH_PERM_SEED = 118
GH_HEAD_ITER = 4          # the cascade head's depth, at the full batch
GH_TAIL_SHOTS = 128       # the last stage's window, at the full depth
GH_BICYCLE_P = 0.03       # syndromes of the bicycle comparison
GH_BP_SHOTS = 2 * BATCH   # the main path with BP forced onto kernel E
GH_FILE_SHOTS = 2 * BATCH  # `simulate` on the .npy files
# configs 1 to 3 (code, decoder, iterations, schedule, p-points, shots)
SMALL_CONFIGS = [
    ("config 1", "shor", "BP", 99, "F", [0.01, 0.05], 1000),
    ("config 2", "steane", "MS", 50, "L", [0.01, 0.03, 0.05], 20000),
    ("config 3 BF", "bicycle", "BF", 50, "F", [0.01, 0.03], 5000),
    ("config 3 NG", "bicycle", "NG", 0, "F", [0.01, 0.03], 5000),
]
# peaks of one H100 SXM: device memory rate, float32 outside tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
# operations per edge and iteration: min-sum's compares, selects and adds;
# BP adds two transcendentals (~20 each) and two IEEE divisions (~8 each)
OPS_MS = 15
OPS_BP = 71
OPS_DRAW = 84  # threefry2x32, 20 rounds, and the threshold compares


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() on the card over `reps` runs after one warm
    run, timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes, n_ops):
    """(least milliseconds the card could take, which side bounds it)."""
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    t_ops = 1e3 * n_ops / PEAK_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def breakdown(pipe, p, names, smi, chunks=BREAKDOWN_CHUNKS, p_index=0):
    """Mean CUDA-event milliseconds of the spans of a chunk over `chunks`
    chunks of the key branch `p_index` (not part of any launch count)."""
    import numpy as np
    import torch

    from qldpcsim_torch.parallel.keys import chunk_keys
    from qldpcsim_torch.utils.threefry import fold_in, prng_key

    dev = pipe.device
    tpc = BATCH // 64
    key_p = fold_in(prng_key(SEED, device=dev), p_index)
    prior = np.float32(p) / np.float32(3.0)
    spans = np.zeros(len(names))
    valid = torch.ones(BATCH, dtype=torch.bool, device=dev)
    for ci in range(chunks):
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(len(names) + 1)]
        kk = chunk_keys(key_p, ci * tpc, tpc)
        ev[0].record()
        ex, ez, sz, sx = pipe._sample_chunk(kk, p)
        ev[1].record()
        rx = pipe.dec_x(sz, prior)
        ev[2].record()
        rz = pipe.dec_z(sx, prior)
        ev[3].record()
        ex_hat, ez_hat = rx.e_hat, rz.e_hat
        if pipe.use_osd:
            ex_hat = pipe._apply_osd(pipe.osd_x, ex_hat, rx.posterior, sz,
                                     ~rx.converged)
            ez_hat = pipe._apply_osd(pipe.osd_z, ez_hat, rz.posterior, sx,
                                     ~rz.converged)
            ev[4].record()
        counts = pipe._count(ex, ez, ex_hat, ez_hat, sz, sx, rx.n_iter,
                             rz.n_iter, valid)
        ev[-1].record()
        ev[-1].synchronize()
        spans += [ev[i].elapsed_time(ev[i + 1]) for i in range(len(names))]
        check(int(counts["decSuccessExact"]) <= BATCH, "breakdown counts")
    spans /= chunks
    total = spans.sum()
    parts = ", ".join(f"{nm} {s:.4f} ({100 * s / total:.1f}%)"
                      for nm, s in zip(names, spans))
    print(f"  chunk breakdown (CUDA events, mean of {chunks} "
          f"chunks, ms): {parts}, total {total:.4f}  [{smi}]")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import qldpcsim_torch

    check(os.path.dirname(os.path.abspath(qldpcsim_torch.__file__))
          == os.path.join(HERE, "qldpcsim_torch"),
          "qldpcsim_torch must be the package beside chip_smoke.py")
    from qldpcsim_torch.codes import get_code
    from qldpcsim_torch.decoders import (
        DecoderConfig, TannerGraph, build_layers, make_decoder)
    from qldpcsim_torch.decoders.osd import OSD, reliability_order
    from qldpcsim_torch.engine.montecarlo import (
        ShotPipeline, SimConfig, simulate, simulate_p)
    from qldpcsim_torch.engine.results import PPointResult
    from qldpcsim_torch.ops import (
        _build, channel_cuda, general_h_cuda, gf2_elim_cuda, ms_qc_cuda,
        seq_qc_cuda)
    from qldpcsim_torch.ops.qc import detect_qc
    from qldpcsim_torch.parallel.keys import chunk_keys
    from qldpcsim_torch.utils.threefry import fold_in, prng_key

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    def reset_launches():
        channel_cuda.LAUNCHES = 0
        gf2_elim_cuda.LAUNCHES = 0
        for k in ms_qc_cuda.LAUNCHES:
            ms_qc_cuda.LAUNCHES[k] = 0
            seq_qc_cuda.LAUNCHES[k] = 0
            general_h_cuda.LAUNCHES[k] = 0

    def read_launches():
        return {"channel": channel_cuda.LAUNCHES,
                "ms_qc MS": ms_qc_cuda.LAUNCHES["MS"],
                "ms_qc BP": ms_qc_cuda.LAUNCHES["BP"],
                "gf2_elim": gf2_elim_cuda.LAUNCHES,
                "seq_qc MS": seq_qc_cuda.LAUNCHES["MS"],
                "seq_qc BP": seq_qc_cuda.LAUNCHES["BP"],
                "general_h MS": general_h_cuda.LAUNCHES["MS"],
                "general_h BP": general_h_cuda.LAUNCHES["BP"]}

    def phase(name):
        print(f"--- {name} (at {time.perf_counter() - t_start:.1f} s)",
              flush=True)

    # 1. toolchain
    phase("1 toolchain")
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    nvcc = _build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    print(f"nvcc {nvcc}: {ver}")
    print(f"card: {smi}")
    print(f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          "(0/1 products are exact either way)")

    # 2. build, one nvcc per source, all at once
    phase("2 build")
    sources = ("channel", "ms_qc", "gf2_elim", "seq_qc", "general_h")
    t0 = time.perf_counter()
    _build.load_all(sources)
    print(f"built {len(sources)} sources in {time.perf_counter() - t0:.2f} s "
          "(concurrent nvcc)")
    for name in sources:
        secs, log = _build.BUILD_INFO[name]
        print(f"build {name}.cu: {secs:.2f} s nvcc")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    code = get_code(CODE)
    Hx = np.asarray(code.Hx) % 2
    Hz = np.asarray(code.Hz) % 2
    n = Hx.shape[1]
    Hx_T = torch.as_tensor(Hx.T, dtype=torch.float32, device=dev)
    Hz_T = torch.as_tensor(Hz.T, dtype=torch.float32, device=dev)

    # 3. kernel A against its plain version
    phase("3 kernel A (channel)")
    key = fold_in(prng_key(SEED, device=dev), 0)
    keys = chunk_keys(key, 0, BATCH // 64)
    worst_a = 0
    for p in (0.01, P_POINT):
        kx, kz = channel_cuda.sample_tiles_cuda(keys, p, n, 64)
        px, pz = channel_cuda.sample_tiles_plain(keys, p, n, 64)
        torch.cuda.synchronize()
        check(kx.shape == (BATCH, n), f"channel shape {tuple(kx.shape)}")
        err = max(int((kx != px).sum()), int((kz != pz).sum()))
        worst_a = max(worst_a, err)
        print(f"channel p={p}: {int(kx.sum())} X, {int(kz.sum())} Z errors; "
              f"elements differing from plain: {err}")
        check(err == 0, f"kernel A == plain at p={p}")
    a_ms = cuda_ms(lambda: channel_cuda.sample_tiles_cuda(keys, P_POINT, n,
                                                          64), 50)
    a_plain = cuda_ms(lambda: channel_cuda.sample_tiles_plain(keys, P_POINT,
                                                              n, 64), 10)
    a_bound = bound(nbytes(keys, kx, kz), kx.numel() * OPS_DRAW)
    print(f"channel ({BATCH // 64} tiles x 64 x {n}): kernel {a_ms:.4f} ms, "
          f"plain {a_plain:.4f} ms, bound {a_bound[0]:.6f} ms "
          f"({a_bound[1]})  [{smi}]")

    def syndromes_at(p):
        ex, ez = channel_cuda.sample_tiles_cuda(keys, p, n, 64)
        return {"X": torch.remainder(ex.float() @ Hz_T, 2.0),
                "Z": torch.remainder(ez.float() @ Hx_T, 2.0)}

    def qc_decoder(H, dec_type, max_iter, sched):
        return ms_qc_cuda.make_qc_decoder(
            detect_qc(H), DecoderConfig(dec_type=dec_type, max_iter=max_iter,
                                        schedule=sched),
            layers=build_layers(H, sched), device=dev)

    def compare_qc(label, dec, syn_T, lch, reps):
        """Kernel B against its plain version on one (m, B) syndrome set:
        prints both times and what differs; returns (kernel ms, plain ms,
        max |posterior diff|, exact?)."""
        kp, ki, kc = ms_qc_cuda.ms_qc_cuda(dec, syn_T, lch)
        pp, pi, pc = ms_qc_cuda.ms_qc_plain(dec, syn_T, lch)
        torch.cuda.synchronize()
        err = float((kp - pp).abs().max())
        diff_shots = int(((kp < 0) != (pp < 0)).any(dim=0).sum())
        same = (torch.equal(ki, pi) and torch.equal(kc, pc)
                and torch.equal(kp, pp))
        k_ms = cuda_ms(lambda: ms_qc_cuda.ms_qc_cuda(dec, syn_T, lch), reps)
        p_ms = cuda_ms(lambda: ms_qc_cuda.ms_qc_plain(dec, syn_T, lch), 1)
        ops = OPS_MS if dec.kind == "MS" else OPS_BP
        bnd = bound(nbytes(syn_T, kp, ki, kc),
                    dec.tabs.n_slots * dec.tabs.L * int(ki.sum()) * ops)
        print(f"{label} (B={syn_T.shape[1]}, {dec.max_iter} it): converged "
              f"{int(kc.sum())}, mean n_iter {float(ki.float().mean()):.4f}; "
              f"vs plain: n_iter differs on {int((ki != pi).sum())}, "
              f"converged on {int((kc != pc).sum())}, e_hat on {diff_shots} "
              f"shots, posterior elements differing "
              f"{int((kp != pp).sum())}, max|post diff| {err}; kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {bnd[0]:.6f} ms "
              f"({bnd[1]}, sum n_iter {int(ki.sum())})  [{smi}]")
        return k_ms, p_ms, err, same, bnd

    # 4. kernel B, kind MS, against its plain version
    phase("4 kernel B, kind MS")
    syn = syndromes_at(P_POINT)
    lch = ms_qc_cuda.llr_prior(np.float32(P_POINT) / np.float32(3.0))
    worst_b = 0.0
    b_times = {}
    for sched in (SCHEDULE, "F"):
        for side, H in (("X", Hz), ("Z", Hx)):
            dec = qc_decoder(H, "MS", MAX_ITER, sched)
            k_ms, p_ms, err, same, bnd = compare_qc(
                f"ms_qc MS {sched} side {side}", dec,
                syn[side].T.contiguous(), lch, 5)
            worst_b = max(worst_b, err)
            b_times[(sched, side)] = (k_ms, p_ms, bnd)
            check(same, f"kernel B MS == plain ({sched}, side {side})")

    # 5. kernel B, kind BP, against its plain version
    phase("5 kernel B, kind BP")
    syn = syndromes_at(C5_P)
    lch5 = ms_qc_cuda.llr_prior(np.float32(C5_P) / np.float32(3.0))
    worst_bp = 0.0
    bp_times = {}
    for side, H in (("X", Hz), ("Z", Hx)):
        dec = qc_decoder(H, "BP", C5_ITER, C5_SCHEDULE)
        k_ms, p_ms, err, same, bnd = compare_qc(
            f"ms_qc BP {C5_SCHEDULE} side {side} p={C5_P}", dec,
            syn[side].T.contiguous(), lch5, 3)
        worst_bp = max(worst_bp, err)
        bp_times[side] = (k_ms, p_ms, bnd)
        check(same, f"kernel B BP == plain (side {side})")

    # 6. kernel C against its plain version, on a window of OSD's inputs
    phase("6 kernel C (GF(2) elimination)")
    dec = qc_decoder(Hz, "BP", C5_ITER, C5_SCHEDULE)
    syn_T = syndromes_at(ELIM_P)["X"].T.contiguous()
    post, _, conv = ms_qc_cuda.ms_qc_cuda(
        dec, syn_T, ms_qc_cuda.llr_prior(np.float32(ELIM_P) / np.float32(3)))
    perms = reliability_order(post.T[~conv])[:ELIM_WINDOW]
    n_failed = perms.shape[0]
    rng = np.random.default_rng(SEED)
    extra = [rng.permutation(n) for _ in range(ELIM_WINDOW - n_failed)]
    if extra:
        perms = torch.cat([perms, torch.from_numpy(np.stack(extra)).to(dev)])
    osd = OSD(Hz, C5_ORDER, device=dev)
    colsP = osd.cols[perms]
    kt, kp, ks = gf2_elim_cuda.eliminate_cuda(colsP, osd.r, osd.rW)
    pt, pp, ps = gf2_elim_cuda.eliminate_plain(colsP, osd.r, osd.rW)
    torch.cuda.synchronize()
    c_same = (torch.equal(kt, pt) and torch.equal(kp, pp)
              and torch.equal(ks, ps))
    c_err = int((kt != pt).sum() + (kp != pp).sum() + (ks != ps).sum())
    c_ms = cuda_ms(
        lambda: gf2_elim_cuda.eliminate_cuda(colsP, osd.r, osd.rW), 20)
    c_plain = cuda_ms(
        lambda: gf2_elim_cuda.eliminate_plain(colsP, osd.r, osd.rW), 2)
    # each shot's sweep reads its columns up to the last one it selects and
    # folds every selected column into the basis: at least one pass over a
    # column's check and tag words for each
    examined = int(((ks * torch.arange(1, n + 1, device=dev)).max(dim=1)
                    .values).sum())
    c_bound = bound(nbytes(colsP, kt, kp, ks),
                    (examined + int(ks.sum())) * (osd.mW + osd.rW))
    print(f"gf2_elim bound {c_bound[0]:.6f} ms ({c_bound[1]}; {examined} "
          f"columns examined)")
    print(f"gf2_elim window {ELIM_WINDOW} x {n} x {osd.mW} words (r {osd.r}): "
          f"{n_failed} decoder-failed shots of a BP decode at p={ELIM_P} "
          f"in reliability order + {ELIM_WINDOW - n_failed} random orders; "
          f"columns selected per shot {int(ks.sum(dim=1).min())}.."
          f"{int(ks.sum(dim=1).max())}, last selected column "
          f"{int((ks * torch.arange(n, device=dev)).max())}; elements "
          f"differing from plain {c_err}; kernel {c_ms:.4f} ms, plain "
          f"{c_plain:.4f} ms  [{smi}]")
    check(n_failed > 0, "the BP decode left shots for OSD")
    check(c_same, "kernel C == plain")

    # 7. the flagship path
    phase("7 flagship path (MS-L-50, p=0.05)")
    cfg = SimConfig(shots=SHOTS, dec_type="MS", dec_iterations=MAX_ITER,
                    dec_schedule=SCHEDULE, batch_size=BATCH, rng_seed=SEED,
                    device="cuda")
    pipe = ShotPipeline(Hx, Hz, cfg)
    reset_launches()
    res = simulate_p(Hx, Hz, P_POINT, cfg, pipeline=pipe)
    launches = read_launches()
    print(f"main path {CODE} MS-{SCHEDULE} {MAX_ITER} it p={P_POINT}: "
          f"{SHOTS} shots in {SHOTS // BATCH} chunks; launches {launches}")
    print(f"  counters {json.dumps(res.counters)}")
    print(f"  qBLER {res.qbler!r}  qBLER_honest {res.qbler_honest!r}  "
          f"avg iterations X {res.avg_iterations_x!r} Z "
          f"{res.avg_iterations_z!r}")
    print(f"  wall {res.wall_time_s:.3f} s, warm {res.warm_shots} shots in "
          f"{res.warm_time_s:.3f} s = {res.shots_per_s_warm:.1f} shots/s "
          f"[{smi}]")
    check(launches["channel"] > 0 and launches["ms_qc MS"] > 0,
          "kernels A and B (MS) launched on the flagship path")
    c = res.counters
    check(c["decSuccessExact"] + c["DecFailures_X"] <= SHOTS
          and c["successStabilizer"] >= c["decSuccessExact"],
          "counters consistent")
    check(0.0 <= res.qbler < 0.5, f"qBLER {res.qbler} plausible at p=0.05")
    for it in (res.avg_iterations_x, res.avg_iterations_z):
        check(1.0 <= it <= MAX_ITER, f"average iterations {it}")
    breakdown(pipe, P_POINT, ("channel", "decode X", "decode Z", "classify"),
              smi)

    # 8. cross-device: the flagship's first chunks on the CPU and the card
    phase("8 flagship cross-device")
    small = {}
    for device in ("cpu", "cuda"):
        r = simulate_p(Hx, Hz, P_POINT, dataclasses.replace(
            cfg, shots=CROSS_CHUNKS * BATCH, device=device))
        small[device] = dict(r.counters, nIterAccX=r.avg_iterations_x * r.shots,
                             nIterAccZ=r.avg_iterations_z * r.shots)
    print(f"cross-device, first {CROSS_CHUNKS} chunks: cpu {small['cpu']}")
    print(f"cross-device, first {CROSS_CHUNKS} chunks: cuda {small['cuda']}")
    check(small["cpu"] == small["cuda"], "GPU counters == CPU counters")

    # 9. config 5
    phase("9 config 5 (BP-F-99 + OSD-2, p=0.03)")
    cfg5 = SimConfig(shots=C5_SHOTS, dec_type="BP", dec_iterations=C5_ITER,
                     dec_schedule=C5_SCHEDULE, osd_order=C5_ORDER,
                     batch_size=BATCH, rng_seed=SEED, device="cuda")
    pipe5 = ShotPipeline(Hx, Hz, cfg5)
    reset_launches()
    res5 = simulate_p(Hx, Hz, C5_P, cfg5, pipeline=pipe5)
    launches5 = read_launches()
    print(f"config 5 {CODE} BP-{C5_SCHEDULE} {C5_ITER} it OSD-{C5_ORDER} "
          f"p={C5_P}: {C5_SHOTS} shots in {C5_SHOTS // BATCH} chunks; "
          f"launches {launches5}")
    print(f"  counters {json.dumps(res5.counters)}")
    print(f"  qBLER {res5.qbler!r}  qBLER_honest {res5.qbler_honest!r}  "
          f"avg iterations X {res5.avg_iterations_x!r} Z "
          f"{res5.avg_iterations_z!r}")
    print(f"  shots that reached OSD: X {pipe5.osd_shots['x']}, Z "
          f"{pipe5.osd_shots['z']}")
    print(f"  wall {res5.wall_time_s:.3f} s, warm {res5.warm_shots} shots in "
          f"{res5.warm_time_s:.3f} s = {res5.shots_per_s_warm:.1f} shots/s "
          f"[{smi}]")
    check(launches5["channel"] > 0 and launches5["ms_qc BP"] > 0,
          "kernels A and B (BP) launched on the config-5 path")
    check(launches5["gf2_elim"] > 0,
          "kernel C launched on the config-5 path (OSD had work)")
    check(launches5["ms_qc MS"] == 0, "no min-sum launch on the BP path")
    c = res5.counters
    check(c["decSuccessExact"] + c["DecFailures_X"] <= C5_SHOTS
          and c["successStabilizer"] >= c["decSuccessExact"],
          "config-5 counters consistent")
    check(0.0 <= res5.qbler < 0.5, f"qBLER {res5.qbler} plausible")
    for it in (res5.avg_iterations_x, res5.avg_iterations_z):
        check(1.0 <= it <= C5_ITER, f"average iterations {it}")
    breakdown(pipe5, C5_P, ("channel", "decode X", "decode Z", "OSD",
                            "classify"), smi)

    # 10. config 5 cross-device: the first chunks on the CPU and the card
    phase("10 config 5 cross-device")
    tpc = BATCH // 64
    est, tot = {}, {}
    for device in ("cpu", "cuda"):
        pd = ShotPipeline(Hx, Hz, dataclasses.replace(cfg5, device=device))
        kd = fold_in(prng_key(SEED, device=pd.device), 0)
        est[device], tot[device] = [], {}
        for ci in range(CROSS_CHUNKS):
            ex, ez, sz, sx = pd._sample_chunk(
                chunk_keys(kd, ci * tpc, tpc), C5_P)
            valid = torch.ones(BATCH, dtype=torch.bool, device=pd.device)
            ex_hat, ez_hat, it_x, it_z = pd._decode(sz, sx, C5_P, valid)
            est[device].append((ex_hat.cpu(), ez_hat.cpu()))
            for k, v in pd._count(ex, ez, ex_hat, ez_hat, sz, sx, it_x, it_z,
                                  valid).items():
                tot[device][k] = tot[device].get(k, 0) + int(v)
    n_diff = sum(int(((a[0] != b[0]).any(dim=1) | (a[1] != b[1]).any(dim=1))
                     .sum()) for a, b in zip(est["cpu"], est["cuda"]))
    shots = CROSS_CHUNKS * BATCH
    q = {d: PPointResult(p=C5_P, shots=shots, counters=tot[d],
                         avg_iterations_x=0.0, avg_iterations_z=0.0).qbler
         for d in tot}
    pool = (q["cpu"] + q["cuda"]) / 2
    sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
    print(f"config 5 cross-device, first {CROSS_CHUNKS} chunks: cpu "
          f"{tot['cpu']}")
    print(f"config 5 cross-device, first {CROSS_CHUNKS} chunks: cuda "
          f"{tot['cuda']}")
    print(f"  counters equal: {tot['cpu'] == tot['cuda']}; shots whose final "
          f"estimate differs: {n_diff} of {shots}; qBLER cpu {q['cpu']!r}, "
          f"cuda {q['cuda']!r}, |diff| {abs(q['cpu'] - q['cuda'])!r} vs "
          f"4 sigma {4 * sigma!r}")
    check(abs(q["cpu"] - q["cuda"]) <= 4 * sigma,
          "config-5 qBLER on the card within 4 sigma of the CPU")

    # 11, 12. kernel D against its plain version, on the Tanner code
    tanner = get_code("tanner")
    Tx = np.asarray(tanner.Hx) % 2
    Tz = np.asarray(tanner.Hz) % 2
    nT = Tx.shape[1]
    ex, ez = channel_cuda.sample_tiles_cuda(keys, SEQ_P, nT, 64)
    synT = {"X": torch.remainder(ex.float() @ torch.as_tensor(
                Tz.T, dtype=torch.float32, device=dev), 2.0).T.contiguous(),
            "Z": torch.remainder(ez.float() @ torch.as_tensor(
                Tx.T, dtype=torch.float32, device=dev), 2.0).T.contiguous()}
    lch_seq = ms_qc_cuda.llr_prior(np.float32(SEQ_P) / np.float32(3.0))

    def seq_decoder(H, kind_, max_iter):
        return seq_qc_cuda.make_seq_qc_decoder(
            detect_qc(H), DecoderConfig(dec_type=kind_, max_iter=max_iter,
                                        schedule="S"),
            layers=build_layers(H, "S"), device=dev, kind=kind_)

    def compare_seq(label, dec, syn_T, reps):
        """Kernel D against its plain version on one (m, B) syndrome set;
        returns (kernel ms, plain ms, max |posterior diff|, equal?, bound).
        The posterior is compared by value (a thread that has left keeps a
        stored -0.0 where the plain version's masked update stores +0.0)."""
        kp, ki, kc = seq_qc_cuda.seq_qc_cuda(dec, syn_T, lch_seq)
        t0 = time.perf_counter()
        pp, pi, pc = seq_qc_cuda.seq_qc_plain(dec, syn_T, lch_seq)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        err = float((kp - pp).abs().max())
        diff_shots = int(((kp < 0) != (pp < 0)).any(dim=0).sum())
        same = (torch.equal(ki, pi) and torch.equal(kc, pc)
                and diff_shots == 0 and torch.equal(kp, pp))
        k_ms = cuda_ms(lambda: seq_qc_cuda.seq_qc_cuda(dec, syn_T, lch_seq),
                       reps)
        ops = OPS_MS if dec.kind == "MS" else OPS_BP
        bnd = bound(nbytes(syn_T, kp, ki, kc),
                    dec.tabs.n_slots * dec.tabs.L * int(ki.sum()) * ops)
        print(f"{label} (B={syn_T.shape[1]}, {dec.max_iter} it): converged "
              f"{int(kc.sum())}, mean n_iter {float(ki.float().mean()):.4f}; "
              f"vs plain: n_iter differs on {int((ki != pi).sum())}, "
              f"converged on {int((kc != pc).sum())}, e_hat on {diff_shots} "
              f"shots, posterior elements differing by value "
              f"{int((kp != pp).sum())}, max|post diff| {err}; kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms (one run, host clock), "
              f"bound {bnd[0]:.6f} ms ({bnd[1]}, sum n_iter "
              f"{int(ki.sum())}, {nbytes(syn_T, kp, ki, kc)} bytes)  [{smi}]")
        return k_ms, p_ms, err, same, bnd

    d_times, worst_d = {}, {}
    for number, kind_ in ((11, "MS"), (12, "BP")):
        phase(f"{number} kernel D, kind {kind_}")
        print(f"depth chosen: B={BATCH} at {SEQ_HEAD_ITER} iterations on both "
              f"sides, B={SEQ_TAIL_SHOTS} at {C4_ITER} iterations on side X; "
              f"kernel alone at B={BATCH} and {C4_ITER} iterations")
        worst_d[kind_] = 0.0
        for side, H in (("X", Tz), ("Z", Tx)):
            out = compare_seq(f"seq_qc {kind_} side {side} p={SEQ_P}",
                              seq_decoder(H, kind_, SEQ_HEAD_ITER),
                              synT[side], 5)
            worst_d[kind_] = max(worst_d[kind_], out[2])
            d_times[(kind_, side)] = out
            check(out[3], f"kernel D {kind_} == plain (side {side}, head)")
        # the tail window: shots the head left unconverged, at full depth
        kc = seq_qc_cuda.seq_qc_cuda(seq_decoder(Tz, kind_, SEQ_HEAD_ITER),
                                     synT["X"], lch_seq)[2]
        tail = torch.nonzero(~kc).flatten()[:SEQ_TAIL_SHOTS]
        check(tail.numel() == SEQ_TAIL_SHOTS, "the head left a tail window")
        out = compare_seq(f"seq_qc {kind_} side X tail window",
                          seq_decoder(Tz, kind_, C4_ITER),
                          synT["X"][:, tail].contiguous(), 3)
        worst_d[kind_] = max(worst_d[kind_], out[2])
        check(out[3], f"kernel D {kind_} == plain (side X, tail window)")
        deep = seq_decoder(Tz, kind_, C4_ITER)
        full_ms = cuda_ms(lambda: seq_qc_cuda.seq_qc_cuda(
            deep, synT["X"], lch_seq), 3)
        ki = seq_qc_cuda.seq_qc_cuda(deep, synT["X"], lch_seq)[1]
        one = synT["X"][:, tail[:1]].contiguous()
        lone_ms = cuda_ms(lambda: seq_qc_cuda.seq_qc_cuda(
            deep, one, lch_seq), 3)
        lone_it = int(seq_qc_cuda.seq_qc_cuda(deep, one, lch_seq)[1][0])
        print(f"seq_qc {kind_} side X, kernel alone: B={BATCH} at {C4_ITER} "
              f"it {full_ms:.3f} ms (mean n_iter "
              f"{float(ki.float().mean()):.4f}, at the cap "
              f"{int((ki == C4_ITER).sum())}); a lone thread {lone_ms:.3f} ms "
              f"for {lone_it} iterations = {lone_ms / lone_it:.4f} ms per "
              f"iteration  [{smi}]")

    # 13. config 4 through the p-sweep entry point, uncut
    phase("13 config 4 (Tanner, MS-S-30, p-sweep)")
    files4 = [os.path.join(HERE, f) for f in C4_FILES]
    # one sweep for the results table and the launch counts of the path
    reset_launches()
    res4 = simulate(files4[0], files4[1], C4_P, shots=C4_SHOTS,
                    decType="MS", decIterations=C4_ITER, decSchedule="S",
                    rngSeed=SEED)
    launches4 = read_launches()
    print(f"config 4 tanner MS-S {C4_ITER} it, p={C4_P}: {C4_SHOTS} shots per "
          f"p in {C4_SHOTS // BATCH} chunks; launches of the sweep "
          f"{launches4}")
    check(launches4["channel"] > 0 and launches4["seq_qc MS"] > 0,
          "kernels A and D (MS) launched on the config-4 path")
    check(launches4["ms_qc MS"] == 0 and launches4["ms_qc BP"] == 0
          and launches4["seq_qc BP"] == 0 and launches4["gf2_elim"] == 0
          and launches4["general_h MS"] == 0
          and launches4["general_h BP"] == 0,
          "no other decoder kernel on the config-4 path")
    check(len(res4) == len(C4_P), "one result per p")
    # per p once more on one pipeline, for launches and lanes per p
    cfg4 = SimConfig(shots=C4_SHOTS, dec_type="MS", dec_iterations=C4_ITER,
                     dec_schedule="S", rng_seed=SEED, device="cuda")
    pipe4 = ShotPipeline(Tx, Tz, cfg4)
    check(pipe4.batch == BATCH, f"config-4 chunk {pipe4.batch}")
    prev_q = -1.0
    for i, pT in enumerate(C4_P):
        for d in (pipe4.dec_x, pipe4.dec_z):
            d.stage_lanes = [0] * len(d.stages)
            d.guard_fired = 0
        before = read_launches()
        r = simulate_p(Tx, Tz, pT, cfg4, pipeline=pipe4, p_index=i)
        after = read_launches()
        check(r.counters == res4[i].counters, f"p={pT}: the sweep's counters")
        print(f"  p={pT}: counters {json.dumps(r.counters)}")
        print(f"    qBLER {r.qbler!r}  qBLER_honest {r.qbler_honest!r}  avg "
              f"iterations X {r.avg_iterations_x!r} Z {r.avg_iterations_z!r}")
        print(f"    warm {r.warm_shots} shots in {r.warm_time_s:.3f} s = "
              f"{r.shots_per_s_warm:.1f} shots/s (in the sweep: "
              f"{res4[i].shots_per_s_warm:.1f}); launches "
              f"{ {k: after[k] - before[k] for k in after if after[k] != before[k]} }"
              f"  [{smi}]")
        print(f"    lanes per cascade stage {pipe4.dec_x.stages}: X "
              f"{pipe4.dec_x.stage_lanes}, Z {pipe4.dec_z.stage_lanes}; "
              f"high-p guard fired in {pipe4.dec_x.guard_fired} (X) and "
              f"{pipe4.dec_z.guard_fired} (Z) of {C4_SHOTS // BATCH} chunks")
        c = r.counters
        check(c["decSuccessExact"] + c["DecFailures_X"] <= C4_SHOTS
              and c["successStabilizer"] >= c["decSuccessExact"],
              "config-4 counters consistent")
        check(prev_q <= r.qbler <= 1.0, f"qBLER {r.qbler} grows with p")
        prev_q = r.qbler
        for it in (r.avg_iterations_x, r.avg_iterations_z):
            check(1.0 <= it <= C4_ITER, f"average iterations {it}")
        if pT in (C4_P[0], C4_P[-1]):
            breakdown(pipe4, pT, ("channel", "decode X", "decode Z",
                                  "classify"), smi,
                      chunks=C4_BREAKDOWN_CHUNKS, p_index=i)
    check(pipe4.dec_x.guard_fired > 0 and pipe4.dec_z.guard_fired > 0,
          f"the high-p guard fired at p={C4_P[-1]}")
    check(res4[0].qbler < 0.01 and res4[-1].qbler > 0.5,
          "config-4 qBLER spans the waterfall")
    # the same entry point with BP: kernel D's other kind on a main path
    reset_launches()
    res4b = simulate(files4[0], files4[1], [C4_P[1]], shots=C4_BP_SHOTS,
                     decType="BP", decIterations=C4_ITER, decSchedule="S",
                     rngSeed=SEED)
    launches4b = read_launches()
    print(f"config 4 with BP, p={C4_P[1]}, {C4_BP_SHOTS} shots: qBLER "
          f"{res4b[0].qbler!r}, avg iterations X "
          f"{res4b[0].avg_iterations_x!r}; launches {launches4b}")
    check(launches4b["seq_qc BP"] > 0 and launches4b["seq_qc MS"] == 0,
          "kernel D (BP) launched on the BP serial path")
    check(0.0 <= res4b[0].qbler < 0.5, "BP serial qBLER plausible")

    # 14. config 4 cross-device: the first chunks on the CPU and the card
    phase("14 config 4 cross-device")
    small4 = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        r = simulate_p(Tx, Tz, C4_P[1], dataclasses.replace(
            cfg4, shots=C4_CROSS_CHUNKS * BATCH, device=device), p_index=1)
        small4[device] = dict(r.counters,
                              nIterAccX=r.avg_iterations_x * r.shots,
                              nIterAccZ=r.avg_iterations_z * r.shots)
        print(f"config 4 cross-device p={C4_P[1]}, first {C4_CROSS_CHUNKS} "
              f"chunk: {device} {small4[device]} "
              f"({time.perf_counter() - t0:.1f} s)")
    check(small4["cpu"] == small4["cuda"],
          "config 4: GPU counters == CPU counters")

    # 15, 16. kernel E against its plain version, on matrices with no lift
    perm = np.random.default_rng(GH_PERM_SEED).permutation(n)
    Px, Pz = Hx[:, perm].astype(np.int8), Hz[:, perm].astype(np.int8)
    check(detect_qc(Px) is None and detect_qc(Pz) is None
          and not ((Px.astype(np.int64) @ Pz.T) % 2).any(),
          "the permuted lp118_0 is a CSS code with no circulant lift")
    bic = get_code("bicycle")
    Bz = (np.asarray(bic.Hz) % 2).astype(np.int8)
    rng = np.random.default_rng(7)
    Irr = np.zeros((Px.shape[0], n), np.int8)
    for i in range(Irr.shape[0]):
        Irr[i, rng.choice(n, int(rng.integers(3, 9)), replace=False)] = 1
    check(detect_qc(Irr) is None and len(set(Irr.sum(axis=1))) >= 5,
          "the irregular matrix has row weights 3 to 8 and no lift")

    def syn_of(H, p):
        """(m, B) syndromes of the port's channel's X errors through H."""
        ex = channel_cuda.sample_tiles_cuda(keys, p, H.shape[1], 64)[0]
        return torch.remainder(ex.float() @ torch.as_tensor(
            H.T, dtype=torch.float32, device=dev), 2.0).T.contiguous()

    def gh_decoder(H, kind_, max_iter, sched):
        return general_h_cuda.make_gh_decoder(
            H, DecoderConfig(dec_type=kind_, max_iter=max_iter,
                             schedule=sched),
            layers=build_layers(H, sched), device=dev, kind=kind_)

    def compare_gh(label, H, dec, syn_T, reps):
        """Kernel E against its plain version on one (m, B) syndrome set;
        returns (kernel ms, plain ms, max |posterior diff|, equal?, bound).
        The posterior is compared by value (a thread that has left keeps a
        stored -0.0 where the plain version's `post + 0` stores +0.0)."""
        kp, ki, kc = general_h_cuda.general_h_cuda(dec, syn_T, lch)
        t0 = time.perf_counter()
        pp, pi, pc = general_h_cuda.general_h_plain(dec, syn_T, lch)
        torch.cuda.synchronize()
        p_ms = 1e3 * (time.perf_counter() - t0)
        err = float((kp - pp).abs().max())
        diff_shots = int(((kp < 0) != (pp < 0)).any(dim=0).sum())
        same = (torch.equal(ki, pi) and torch.equal(kc, pc)
                and diff_shots == 0 and torch.equal(kp, pp))
        k_ms = cuda_ms(lambda: general_h_cuda.general_h_cuda(dec, syn_T, lch),
                       reps)
        ops = OPS_MS if dec.kind == "MS" else OPS_BP
        bnd = bound(nbytes(syn_T, kp, ki, kc),
                    int(H.sum()) * int(ki.sum()) * ops)
        print(f"{label} (B={syn_T.shape[1]}, {dec.max_iter} it, "
              f"{len(dec.tabs.runs)} layers, dmax {dec.tabs.dmax}): converged "
              f"{int(kc.sum())}, mean n_iter {float(ki.float().mean()):.4f}; "
              f"vs plain: n_iter differs on {int((ki != pi).sum())}, "
              f"converged on {int((kc != pc).sum())}, e_hat on {diff_shots} "
              f"shots, posterior elements differing by value "
              f"{int((kp != pp).sum())}, max|post diff| {err}; kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms (one run, host clock), "
              f"bound {bnd[0]:.6f} ms ({bnd[1]}, sum n_iter "
              f"{int(ki.sum())}, {nbytes(syn_T, kp, ki, kc)} bytes)  [{smi}]")
        return k_ms, p_ms, err, same, bnd

    syn_perm = syn_of(Pz, P_POINT)
    syn_bic = syn_of(Bz, GH_BICYCLE_P)
    syn_irr = syn_of(Irr, 0.017)
    e_times, worst_e = {}, {}
    for number, kind_ in ((15, "MS"), (16, "BP")):
        phase(f"{number} kernel E, kind {kind_}")
        print(f"depth chosen: B={BATCH} at {GH_HEAD_ITER} iterations, "
              f"B={GH_TAIL_SHOTS} at {MAX_ITER} iterations on the permuted "
              f"{CODE}; kernel alone at B={BATCH} and {MAX_ITER} iterations")
        worst_e[kind_] = 0.0
        for sched in (SCHEDULE, "F"):
            out = compare_gh(f"general_h {kind_} {sched} permuted {CODE} "
                             f"side X p={P_POINT}", Pz,
                             gh_decoder(Pz, kind_, GH_HEAD_ITER, sched),
                             syn_perm, 5)
            worst_e[kind_] = max(worst_e[kind_], out[2])
            e_times[(kind_, sched)] = out
            check(out[3], f"kernel E {kind_} == plain ({sched}, head)")
            # the tail window: shots the head left unconverged, full depth
            kc = general_h_cuda.general_h_cuda(
                gh_decoder(Pz, kind_, GH_HEAD_ITER, sched), syn_perm, lch)[2]
            tail = torch.nonzero(~kc).flatten()[:GH_TAIL_SHOTS]
            check(tail.numel() == GH_TAIL_SHOTS,
                  "the head left a tail window")
            deep = gh_decoder(Pz, kind_, MAX_ITER, sched)
            out = compare_gh(f"general_h {kind_} {sched} tail window", Pz,
                             deep, syn_perm[:, tail].contiguous(), 3)
            worst_e[kind_] = max(worst_e[kind_], out[2])
            e_times[(kind_, sched, "tail")] = out
            check(out[3], f"kernel E {kind_} == plain ({sched}, tail window)")
            full_ms = cuda_ms(lambda: general_h_cuda.general_h_cuda(
                deep, syn_perm, lch), 3)
            ki = general_h_cuda.general_h_cuda(deep, syn_perm, lch)[1]
            one = syn_perm[:, tail[:1]].contiguous()
            lone_ms = cuda_ms(lambda: general_h_cuda.general_h_cuda(
                deep, one, lch), 3)
            lone_it = int(general_h_cuda.general_h_cuda(deep, one, lch)[1][0])
            print(f"general_h {kind_} {sched}, kernel alone: B={BATCH} at "
                  f"{MAX_ITER} it {full_ms:.3f} ms (mean n_iter "
                  f"{float(ki.float().mean()):.4f}, at the cap "
                  f"{int((ki == MAX_ITER).sum())}); a lone thread "
                  f"{lone_ms:.3f} ms for {lone_it} iterations = "
                  f"{lone_ms / lone_it:.4f} ms per iteration  [{smi}]")
        for label, H, syn_T in (("bicycle", Bz, syn_bic),
                                ("irregular 240x544", Irr, syn_irr)):
            out = compare_gh(f"general_h {kind_} {SCHEDULE} {label}", H,
                             gh_decoder(H, kind_, GH_HEAD_ITER, SCHEDULE),
                             syn_T, 5)
            worst_e[kind_] = max(worst_e[kind_], out[2])
            check(out[3], f"kernel E {kind_} == plain ({label})")

    # 17. the non-QC main path
    phase("17 non-QC main path (permuted lp118_0, MS-L-50, p=0.05)")
    cfgE = SimConfig(shots=SHOTS, dec_type="MS", dec_iterations=MAX_ITER,
                     dec_schedule=SCHEDULE, batch_size=BATCH, rng_seed=SEED,
                     device="cuda")
    pipeE = ShotPipeline(Px, Pz, cfgE)
    reset_launches()
    resE = simulate_p(Px, Pz, P_POINT, cfgE, pipeline=pipeE)
    launchesE = read_launches()
    print(f"non-QC main path, permuted {CODE} MS-{SCHEDULE} {MAX_ITER} it "
          f"p={P_POINT}, impl auto: {SHOTS} shots in {SHOTS // BATCH} chunks; "
          f"launches {launchesE}")
    print(f"  counters {json.dumps(resE.counters)}")
    print(f"  qBLER {resE.qbler!r}  qBLER_honest {resE.qbler_honest!r}  "
          f"avg iterations X {resE.avg_iterations_x!r} Z "
          f"{resE.avg_iterations_z!r}")
    print(f"  wall {resE.wall_time_s:.3f} s, warm {resE.warm_shots} shots in "
          f"{resE.warm_time_s:.3f} s = {resE.shots_per_s_warm:.1f} shots/s "
          f"[{smi}]")
    print(f"  lanes per cascade stage {pipeE.dec_x.stages}: X "
          f"{pipeE.dec_x.stage_lanes}, Z {pipeE.dec_z.stage_lanes}")
    check(launchesE["channel"] > 0 and launchesE["general_h MS"] > 0,
          "kernels A and E (MS) launched on the non-QC main path")
    check(all(v == 0 for k, v in launchesE.items()
              if k not in ("channel", "general_h MS")),
          "no other kernel on the non-QC main path")
    c = resE.counters
    check(c["decSuccessExact"] + c["DecFailures_X"] <= SHOTS
          and c["successStabilizer"] >= c["decSuccessExact"],
          "non-QC counters consistent")
    for it in (resE.avg_iterations_x, resE.avg_iterations_z):
        check(1.0 <= it <= MAX_ITER, f"average iterations {it}")
    pool = (res.qbler + resE.qbler) / 2
    sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / SHOTS)
    print(f"  qBLER against the flagship's (the same code, qubits "
          f"relabelled): {resE.qbler!r} vs {res.qbler!r}, |diff| "
          f"{abs(res.qbler - resE.qbler)!r} vs 4 sigma {4 * sigma!r}")
    check(abs(res.qbler - resE.qbler) <= 4 * sigma,
          "non-QC qBLER within 4 sigma of the flagship's")
    breakdown(pipeE, P_POINT, ("channel", "decode X", "decode Z", "classify"),
              smi)
    # the reference's input mode: the matrices as .npy files
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        np.save(os.path.join(tmp, "Hx.npy"), Px)
        np.save(os.path.join(tmp, "Hz.npy"), Pz)
        reset_launches()
        resF = simulate(os.path.join(tmp, "Hx.npy"),
                        os.path.join(tmp, "Hz.npy"), [P_POINT],
                        shots=GH_FILE_SHOTS, decType="MS",
                        decIterations=MAX_ITER, decSchedule=SCHEDULE,
                        rngSeed=SEED)
    print(f"simulate on the .npy files, {GH_FILE_SHOTS} shots: counters "
          f"{json.dumps(resF[0].counters)}; launches {read_launches()}")
    check(general_h_cuda.LAUNCHES["MS"] > 0, "kernel E launched by path")
    # the same path with BP forced onto kernel E
    reset_launches()
    resEb = simulate_p(Px, Pz, P_POINT, dataclasses.replace(
        cfgE, shots=GH_BP_SHOTS, dec_type="BP", impl="gh"))
    launchesEb = read_launches()
    print(f"non-QC path with BP, impl gh, {GH_BP_SHOTS} shots: qBLER "
          f"{resEb.qbler!r}, avg iterations X {resEb.avg_iterations_x!r}; "
          f"launches {launchesEb}")
    check(launchesEb["general_h BP"] > 0 and launchesEb["general_h MS"] == 0,
          "kernel E (BP) launched on the forced BP path")
    check(0.0 <= resEb.qbler < 0.5, "BP general-H qBLER plausible")

    # 18. non-QC cross-device: the first chunks on the CPU and the card
    phase("18 non-QC cross-device")
    smallE = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        r = simulate_p(Px, Pz, P_POINT, dataclasses.replace(
            cfgE, shots=CROSS_CHUNKS * BATCH, device=device))
        smallE[device] = dict(r.counters,
                              nIterAccX=r.avg_iterations_x * r.shots,
                              nIterAccZ=r.avg_iterations_z * r.shots)
        print(f"non-QC cross-device, first {CROSS_CHUNKS} chunks: {device} "
              f"{smallE[device]} ({time.perf_counter() - t0:.1f} s)")
    check(smallE["cpu"] == smallE["cuda"],
          "non-QC main path: GPU counters == CPU counters")
    check(smallE["cuda"] == dict(
        resF[0].counters,
        nIterAccX=resF[0].avg_iterations_x * resF[0].shots,
        nIterAccZ=resF[0].avg_iterations_z * resF[0].shots),
        "`simulate` by path gives the counters of `simulate_p`")

    # 19. the incidence decoders beside kernel E, one side, through
    # make_decoder (cascade included)
    phase("19 incidence path against kernel E (one side, B=4096)")
    graphP = TannerGraph.build(Pz)
    synB = syn_perm.T.contiguous()
    prior = np.float32(P_POINT) / np.float32(3.0)
    for sched in (SCHEDULE, "F"):
        outs, ms_of = {}, {}
        for impl in ("gh", "mxu"):
            dec = make_decoder(graphP, DecoderConfig(
                dec_type="MS", max_iter=MAX_ITER, schedule=sched, impl=impl),
                device=dev)
            ms_of[impl] = cuda_ms(lambda: dec(synB, prior), 3)
            outs[impl] = dec(synB, prior)
        a, b = outs["gh"], outs["mxu"]
        print(f"one side, B={BATCH}, MS-{sched} {MAX_ITER} it with the "
              f"cascade: kernel E {ms_of['gh']:.3f} ms, incidence decoder "
              f"{ms_of['mxu']:.3f} ms; shots whose estimates differ "
              f"{int((a.e_hat != b.e_hat).any(dim=1).sum())}, n_iter "
              f"{int((a.n_iter != b.n_iter).sum())}, converged "
              f"{int((a.converged != b.converged).sum())}  [{smi}]")
        check(a.e_hat.shape == b.e_hat.shape == (BATCH, n),
              "both paths decode the batch")

    # 20. configs 1 to 3 at their own sizes
    phase("20 configs 1-3")
    for label, code_, dec_type, iters, sched, ps, shots_ in SMALL_CONFIGS:
        cs = get_code(code_)
        cfgS = SimConfig(shots=shots_, dec_type=dec_type,
                         dec_iterations=iters, dec_schedule=sched,
                         rng_seed=SEED, device="cuda")
        pipes = {d: ShotPipeline(cs.Hx, cs.Hz, dataclasses.replace(
            cfgS, device=d)) for d in ("cuda", "cpu")}
        dec0 = pipes["cuda"].dec_x
        dec0 = dec0.decs[0] if hasattr(dec0, "decs") else dec0
        print(f"{label}: {code_} {dec_type}-{sched} {iters} it, {shots_} "
              f"shots per p in chunks of {pipes['cuda'].batch}; decoder "
              f"{type(dec0).__name__}")
        for i, pT in enumerate(ps):
            reset_launches()
            r = simulate_p(cs.Hx, cs.Hz, pT, cfgS, pipeline=pipes["cuda"],
                           p_index=i)
            la = read_launches()
            # once more, now warm from the first chunk on
            t0 = time.perf_counter()
            r2 = simulate_p(cs.Hx, cs.Hz, pT, cfgS, pipeline=pipes["cuda"],
                            p_index=i)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            check(r2.counters == r.counters, f"{label}: a rerun's counters")
            print(f"  p={pT}: counters {json.dumps(r.counters)}")
            print(f"    qBLER {r.qbler!r}  avg iterations X "
                  f"{r.avg_iterations_x!r} Z {r.avg_iterations_z!r}; second "
                  f"run {shots_} shots in {secs:.4f} s = "
                  f"{shots_ / secs:.1f} shots/s; launches "
                  f"{ {k: v for k, v in la.items() if v} }  [{smi}]")
            check(la["channel"] > 0 and sum(la.values()) == la["channel"],
                  f"{label}: the channel kernel and plain-torch decoders")
            check(r.counters["decSuccessExact"] <= shots_
                  and 0.0 <= r.qbler <= 1.0, f"{label} counters consistent")
            if dec_type != "BP":
                rc = simulate_p(cs.Hx, cs.Hz, pT, dataclasses.replace(
                    cfgS, device="cpu"), pipeline=pipes["cpu"], p_index=i)
                same = (rc.counters == r.counters
                        and rc.avg_iterations_x == r.avg_iterations_x
                        and rc.avg_iterations_z == r.avg_iterations_z)
                print(f"    counters equal to the CPU run: {same}")
                check(same, f"{label} p={pT}: GPU counters == CPU counters")
        if dec_type in ("MS", "BP"):
            # the same configuration forced onto kernel E, which the routing
            # keeps for 512 edge slots and more: timed, not compared (the
            # incidence decoder tests the syndrome after every layer, kernel
            # E once per iteration, so a shot may latch elsewhere)
            cfgG = dataclasses.replace(cfgS, impl="gh")
            pipeG = ShotPipeline(cs.Hx, cs.Hz, cfgG)
            for i, pT in enumerate(ps):
                reset_launches()
                rg = simulate_p(cs.Hx, cs.Hz, pT, cfgG, pipeline=pipeG,
                                p_index=i)
                lg = read_launches()
                t0 = time.perf_counter()
                simulate_p(cs.Hx, cs.Hz, pT, cfgG, pipeline=pipeG, p_index=i)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                print(f"  p={pT} with impl gh (kernel E): qBLER {rg.qbler!r}, "
                      f"second run {shots_} shots in {secs:.4f} s = "
                      f"{shots_ / secs:.1f} shots/s; launches "
                      f"{ {k: v for k, v in lg.items() if v} }  [{smi}]")
                check(lg[f"general_h {dec_type}"] > 0,
                      f"{label}: kernel E launched when forced")
    print(f"total {time.perf_counter() - t_start:.1f} s")

    def row(name, source, replaces, launches_, err, ms, plain_ms, bnd):
        return {"name": name, "route": "cuda",
                "source": f"qldpcsim_torch/csrc/{source}",
                "replaces": f"qldpcsim_tpu/ops/{replaces}",
                "launches": launches_, "max_abs_err": float(err), "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
                "library_ms": None}

    b_ms, bp_ms = b_times[(SCHEDULE, "X")], bp_times["X"]
    d_ms, d_bp = d_times[("MS", "X")], d_times[("BP", "X")]
    e_ms, e_bp = e_times[("MS", SCHEDULE)], e_times[("BP", SCHEDULE)]
    kernels = [
        row("channel_depolarizing", "channel.cu", "channel_pallas.py:94",
            launches["channel"], worst_a, a_ms, a_plain, a_bound),
        row("ms_qc_decode", "ms_qc.cu", "ms_qc_pallas.py:93",
            launches["ms_qc MS"], worst_b, b_ms[0], b_ms[1], b_ms[2]),
        row("ms_qc_decode_bp", "ms_qc.cu", "ms_qc_pallas.py:93",
            launches5["ms_qc BP"], worst_bp, bp_ms[0], bp_ms[1], bp_ms[2]),
        row("gf2_elim", "gf2_elim.cu", "gf2_elim_panel_pallas.py:51",
            launches5["gf2_elim"], c_err, c_ms, c_plain, c_bound),
        row("seq_qc_decode", "seq_qc.cu", "seq_qc_pallas.py:66",
            launches4["seq_qc MS"], worst_d["MS"], d_ms[0], d_ms[1], d_ms[4]),
        row("seq_qc_decode_bp", "seq_qc.cu", "seq_qc_pallas.py:66",
            launches4b["seq_qc BP"], worst_d["BP"], d_bp[0], d_bp[1],
            d_bp[4]),
        row("general_h_decode", "general_h.cu", "general_h_pallas.py:92",
            launchesE["general_h MS"], worst_e["MS"], e_ms[0], e_ms[1],
            e_ms[4]),
        row("general_h_decode_bp", "general_h.cu", "general_h_pallas.py:92",
            launchesEb["general_h BP"], worst_e["BP"], e_bp[0], e_bp[1],
            e_bp[4]),
    ]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} launched on its main path")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
