#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`qldpcsim_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. toolchain: Python, torch and CUDA versions, nvcc, the card's name and
     power limit;
  2. build the three CUDA kernels from `qldpcsim_torch/csrc/*.cu` with nvcc,
     one process per source, all at once;
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
     layered, 50 iterations, p = 0.05, 4096-shot chunks, 262,144 shots) on
     the card, with the launch counts of its kernels, then a CUDA-event
     breakdown of a chunk into channel, decode X, decode Z and classify;
  8. the flagship's first two chunks through the port on the CPU (plain
     versions) against the same chunks on the card: all 9 counters equal;
  9. config 5: `simulate_p` on lp118_0 (BP, flooding, 99 iterations, OSD-2,
     p = 0.03, 4096-shot chunks, 262,144 shots) on the card, with the
     launch counts of its kernels and the shots that reached OSD, then a
     CUDA-event breakdown of a chunk into channel, decode X, decode Z, OSD
     and classify;
 10. config 5's first two chunks on the CPU against the card: both counter
     sets, the shots whose final estimates differ (BP's tanh and log may
     round differently in the last ulp on the two devices), and qBLER
     within 4 sigma.

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
SHOTS = 64 * BATCH
# config 5: BP, flooding, 99 iterations, OSD-2, p = 0.03
C5_P = 0.03
C5_ITER = 99
C5_SCHEDULE = "F"
C5_ORDER = 2
C5_SHOTS = 64 * BATCH
ELIM_P = 0.05      # the BP decode that fills kernel C's window
ELIM_WINDOW = 256  # the engine's OSD window


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


def breakdown(pipe, p, names, smi):
    """Mean CUDA-event milliseconds of the spans of a chunk over
    BREAKDOWN_CHUNKS chunks (not part of any launch count)."""
    import numpy as np
    import torch

    from qldpcsim_torch.parallel.keys import chunk_keys
    from qldpcsim_torch.utils.threefry import fold_in, prng_key

    dev = pipe.device
    tpc = BATCH // 64
    key_p = fold_in(prng_key(SEED, device=dev), 0)
    prior = np.float32(p) / np.float32(3.0)
    spans = np.zeros(len(names))
    valid = torch.ones(BATCH, dtype=torch.bool, device=dev)
    for ci in range(BREAKDOWN_CHUNKS):
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
    spans /= BREAKDOWN_CHUNKS
    total = spans.sum()
    parts = ", ".join(f"{nm} {s:.4f} ({100 * s / total:.1f}%)"
                      for nm, s in zip(names, spans))
    print(f"  chunk breakdown (CUDA events, mean of {BREAKDOWN_CHUNKS} "
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
    from qldpcsim_torch.decoders import DecoderConfig, build_layers
    from qldpcsim_torch.decoders.osd import OSD, reliability_order
    from qldpcsim_torch.engine.montecarlo import (
        ShotPipeline, SimConfig, simulate_p)
    from qldpcsim_torch.engine.results import PPointResult
    from qldpcsim_torch.ops import (
        _build, channel_cuda, gf2_elim_cuda, ms_qc_cuda)
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

    def read_launches():
        return {"channel": channel_cuda.LAUNCHES,
                "ms_qc MS": ms_qc_cuda.LAUNCHES["MS"],
                "ms_qc BP": ms_qc_cuda.LAUNCHES["BP"],
                "gf2_elim": gf2_elim_cuda.LAUNCHES}

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
    sources = ("channel", "ms_qc", "gf2_elim")
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
    print(f"channel ({BATCH // 64} tiles x 64 x {n}): kernel {a_ms:.4f} ms, "
          f"plain {a_plain:.4f} ms  [{smi}]")

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
        print(f"{label} (B={syn_T.shape[1]}, {dec.max_iter} it): converged "
              f"{int(kc.sum())}, mean n_iter {float(ki.float().mean()):.4f}; "
              f"vs plain: n_iter differs on {int((ki != pi).sum())}, "
              f"converged on {int((kc != pc).sum())}, e_hat on {diff_shots} "
              f"shots, posterior elements differing "
              f"{int((kp != pp).sum())}, max|post diff| {err}; kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms  [{smi}]")
        return k_ms, p_ms, err, same

    # 4. kernel B, kind MS, against its plain version
    phase("4 kernel B, kind MS")
    syn = syndromes_at(P_POINT)
    lch = ms_qc_cuda.llr_prior(np.float32(P_POINT) / np.float32(3.0))
    worst_b = 0.0
    b_times = {}
    for sched in (SCHEDULE, "F"):
        for side, H in (("X", Hz), ("Z", Hx)):
            dec = qc_decoder(H, "MS", MAX_ITER, sched)
            k_ms, p_ms, err, same = compare_qc(
                f"ms_qc MS {sched} side {side}", dec,
                syn[side].T.contiguous(), lch, 5)
            worst_b = max(worst_b, err)
            b_times[(sched, side)] = (k_ms, p_ms)
            check(same, f"kernel B MS == plain ({sched}, side {side})")

    # 5. kernel B, kind BP, against its plain version
    phase("5 kernel B, kind BP")
    syn = syndromes_at(C5_P)
    lch5 = ms_qc_cuda.llr_prior(np.float32(C5_P) / np.float32(3.0))
    worst_bp = 0.0
    bp_times = {}
    for side, H in (("X", Hz), ("Z", Hx)):
        dec = qc_decoder(H, "BP", C5_ITER, C5_SCHEDULE)
        k_ms, p_ms, err, same = compare_qc(
            f"ms_qc BP {C5_SCHEDULE} side {side} p={C5_P}", dec,
            syn[side].T.contiguous(), lch5, 3)
        worst_bp = max(worst_bp, err)
        bp_times[side] = (k_ms, p_ms)
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
    print(f"total {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "channel_depolarizing", "route": "cuda",
         "source": "qldpcsim_torch/csrc/channel.cu",
         "replaces": "qldpcsim_tpu/ops/channel_pallas.py:94",
         "launches": launches["channel"], "max_abs_err": float(worst_a),
         "ms": a_ms, "plain_ms": a_plain},
        {"name": "ms_qc_decode", "route": "cuda",
         "source": "qldpcsim_torch/csrc/ms_qc.cu",
         "replaces": "qldpcsim_tpu/ops/ms_qc_pallas.py:93",
         "launches": launches["ms_qc MS"], "max_abs_err": worst_b,
         "ms": b_times[(SCHEDULE, "X")][0],
         "plain_ms": b_times[(SCHEDULE, "X")][1]},
        {"name": "ms_qc_decode_bp", "route": "cuda",
         "source": "qldpcsim_torch/csrc/ms_qc.cu",
         "replaces": "qldpcsim_tpu/ops/ms_qc_pallas.py:93",
         "launches": launches5["ms_qc BP"], "max_abs_err": worst_bp,
         "ms": bp_times["X"][0], "plain_ms": bp_times["X"][1]},
        {"name": "gf2_elim", "route": "cuda",
         "source": "qldpcsim_torch/csrc/gf2_elim.cu",
         "replaces": "qldpcsim_tpu/ops/gf2_elim_panel_pallas.py:51",
         "launches": launches5["gf2_elim"], "max_abs_err": float(c_err),
         "ms": c_ms, "plain_ms": c_plain},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
