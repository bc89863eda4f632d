#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`qldpcsim_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. toolchain: Python, torch and CUDA versions, nvcc, the card's name and
     power limit;
  2. build both CUDA kernels from `qldpcsim_torch/csrc/*.cu` with nvcc;
  3. kernel A (threefry depolarizing channel) against its plain PyTorch
     version on the card: the flagship chunk's 64 tiles x 64 x 544 at
     p = 0.01 and 0.05, bit-exact;
  4. kernel B (min-sum over a circulant-lifted H) against its plain version
     on the card: 4096 flagship syndromes per side, 50 iterations, layered
     and flooding schedules; e_hat, n_iter, converged and the posterior
     bit-exact;
  5. the main path: `simulate_p` on lp118_0 (normalized min-sum, layered,
     50 iterations, p = 0.05, 4096-shot chunks, 262,144 shots) on the card,
     with both kernels' launch counts, then a CUDA-event breakdown of a
     chunk into channel, decode X, decode Z and classify;
  6. the first two chunks through the port on the CPU (plain versions)
     against the same chunks on the card: all 9 counters equal.

The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}. Exits non-zero, printing neither, when torch
sees no CUDA device or the package is not beside this script.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

CODE = "lp118_0"
P_POINT = 0.05
MAX_ITER = 50
SCHEDULE = "L"
BATCH = 4096
SHOTS = 64 * BATCH
SEED = 0
CROSS_CHUNKS = 2


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
    from qldpcsim_torch.engine.montecarlo import (
        ShotPipeline, SimConfig, simulate_p)
    from qldpcsim_torch.ops import _build, channel_cuda, ms_qc_cuda
    from qldpcsim_torch.ops.qc import detect_qc
    from qldpcsim_torch.parallel.keys import chunk_keys
    from qldpcsim_torch.utils.threefry import fold_in, prng_key

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    # 1. toolchain
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  devices {torch.cuda.device_count()}")
    nvcc = _build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    print(f"nvcc {nvcc}: {ver}")
    print(f"card: {smi}")
    print(f"matmul allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          "(0/1 products are exact either way)")

    # 2. build
    for name in ("channel", "ms_qc"):
        t0 = time.perf_counter()
        _build.load(name)
        secs, log = _build.BUILD_INFO[name]
        print(f"build {name}.cu: {secs:.2f} s nvcc, "
              f"{time.perf_counter() - t0:.2f} s with load")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    code = get_code(CODE)
    Hx = np.asarray(code.Hx) % 2
    Hz = np.asarray(code.Hz) % 2
    n = Hx.shape[1]
    summary = []

    # 3. kernel A against its plain version
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

    # 4. kernel B against its plain version
    sample = channel_cuda.sample_tiles_cuda(keys, P_POINT, n, 64)
    Hx_T = torch.as_tensor(Hx.T, dtype=torch.float32, device=dev)
    Hz_T = torch.as_tensor(Hz.T, dtype=torch.float32, device=dev)
    syn = {"X": torch.remainder(sample[0].float() @ Hz_T, 2.0),
           "Z": torch.remainder(sample[1].float() @ Hx_T, 2.0)}
    lch = ms_qc_cuda.llr_prior(np.float32(P_POINT) / np.float32(3.0))
    worst_b = 0.0
    b_times = {}
    for sched in (SCHEDULE, "F"):
        for side, H in (("X", Hz), ("Z", Hx)):
            dec = ms_qc_cuda.make_qc_decoder(
                detect_qc(H), DecoderConfig(dec_type="MS", max_iter=MAX_ITER,
                                            schedule=sched),
                layers=build_layers(H, sched), device=dev)
            syn_T = syn[side].T.contiguous()
            kp, ki, kc = ms_qc_cuda.ms_qc_cuda(dec, syn_T, lch)
            pp, pi, pc = ms_qc_cuda.ms_qc_plain(dec, syn_T, lch)
            torch.cuda.synchronize()
            err = float((kp - pp).abs().max())
            worst_b = max(worst_b, err)
            same = (torch.equal(kp < 0, pp < 0) and torch.equal(ki, pi)
                    and torch.equal(kc, pc) and torch.equal(kp, pp))
            k_ms = cuda_ms(lambda: ms_qc_cuda.ms_qc_cuda(dec, syn_T, lch), 5)
            p_ms = cuda_ms(lambda: ms_qc_cuda.ms_qc_plain(dec, syn_T, lch), 1)
            b_times[(sched, side)] = (k_ms, p_ms)
            print(f"ms_qc {sched} side {side} (B={BATCH}, {MAX_ITER} it): "
                  f"converged {int(kc.sum())}, mean n_iter "
                  f"{float(ki.float().mean()):.4f}, max|post diff| {err}, "
                  f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms  [{smi}]")
            check(same, f"kernel B == plain ({sched}, side {side})")

    # 5. the main path
    cfg = SimConfig(shots=SHOTS, dec_type="MS", dec_iterations=MAX_ITER,
                    dec_schedule=SCHEDULE, batch_size=BATCH, rng_seed=SEED,
                    device="cuda")
    pipe = ShotPipeline(Hx, Hz, cfg)
    channel_cuda.LAUNCHES = 0
    ms_qc_cuda.LAUNCHES = 0
    res = simulate_p(Hx, Hz, P_POINT, cfg, pipeline=pipe)
    launches = {"channel": channel_cuda.LAUNCHES, "ms_qc": ms_qc_cuda.LAUNCHES}
    print(f"main path {CODE} MS-{SCHEDULE} {MAX_ITER} it p={P_POINT}: "
          f"{SHOTS} shots in {SHOTS // BATCH} chunks; launches {launches}")
    print(f"  counters {json.dumps(res.counters)}")
    print(f"  qBLER {res.qbler!r}  qBLER_honest {res.qbler_honest!r}  "
          f"avg iterations X {res.avg_iterations_x!r} Z "
          f"{res.avg_iterations_z!r}")
    print(f"  wall {res.wall_time_s:.3f} s, warm {res.warm_shots} shots in "
          f"{res.warm_time_s:.3f} s = {res.shots_per_s_warm:.1f} shots/s "
          f"[{smi}]")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} launched on the main path")
    c = res.counters
    check(c["decSuccessExact"] + c["DecFailures_X"] <= SHOTS
          and c["successStabilizer"] >= c["decSuccessExact"],
          "counters consistent")
    check(0.0 <= res.qbler < 0.5, f"qBLER {res.qbler} plausible at p=0.05")
    for it in (res.avg_iterations_x, res.avg_iterations_z):
        check(1.0 <= it <= MAX_ITER, f"average iterations {it}")

    # per-chunk breakdown with CUDA events (not part of the launch count)
    tpc = BATCH // 64
    key_p = fold_in(prng_key(SEED, device=dev), 0)
    spans = np.zeros(4)
    n_chunks = 16
    prior = np.float32(P_POINT) / np.float32(3.0)
    for ci in range(n_chunks):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        kk = chunk_keys(key_p, ci * tpc, tpc)
        valid = torch.ones(BATCH, dtype=torch.bool, device=dev)
        ev[0].record()
        ex, ez, sz, sx = pipe._sample_chunk(kk, P_POINT)
        ev[1].record()
        rx = pipe.dec_x(sz, prior)
        ev[2].record()
        rz = pipe.dec_z(sx, prior)
        ev[3].record()
        counts = pipe._count(ex, ez, rx.e_hat, rz.e_hat, sz, sx, rx.n_iter,
                             rz.n_iter, valid)
        ev[4].record()
        ev[4].synchronize()
        spans += [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
        check(int(counts["decSuccessExact"]) <= BATCH, "breakdown counts")
    spans /= n_chunks
    total = spans.sum()
    print("chunk breakdown (CUDA events, mean of %d chunks, ms): channel "
          "%.4f (%.1f%%), decode X %.4f (%.1f%%), decode Z %.4f (%.1f%%), "
          "classify %.4f (%.1f%%), total %.4f  [%s]" % (
              n_chunks, spans[0], 100 * spans[0] / total, spans[1],
              100 * spans[1] / total, spans[2], 100 * spans[2] / total,
              spans[3], 100 * spans[3] / total, total, smi))

    # 6. cross-device: the first chunks on the CPU against the card
    small = {}
    for device in ("cpu", "cuda"):
        r = simulate_p(Hx, Hz, P_POINT, dataclasses.replace(
            cfg, shots=CROSS_CHUNKS * BATCH, device=device))
        small[device] = dict(r.counters, nIterAccX=r.avg_iterations_x * r.shots,
                             nIterAccZ=r.avg_iterations_z * r.shots)
    print(f"cross-device, first {CROSS_CHUNKS} chunks: cpu {small['cpu']}")
    print(f"cross-device, first {CROSS_CHUNKS} chunks: cuda {small['cuda']}")
    check(small["cpu"] == small["cuda"], "GPU counters == CPU counters")

    kernels = [
        {"name": "channel_depolarizing", "route": "cuda",
         "source": "qldpcsim_torch/csrc/channel.cu",
         "replaces": "qldpcsim_tpu/ops/channel_pallas.py:94",
         "launches": launches["channel"], "max_abs_err": float(worst_a),
         "ms": a_ms, "plain_ms": a_plain},
        {"name": "ms_qc_decode", "route": "cuda",
         "source": "qldpcsim_torch/csrc/ms_qc.cu",
         "replaces": "qldpcsim_tpu/ops/ms_qc_pallas.py:93",
         "launches": launches["ms_qc"], "max_abs_err": worst_b,
         "ms": b_times[(SCHEDULE, "X")][0],
         "plain_ms": b_times[(SCHEDULE, "X")][1]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
