#!/usr/bin/env python3
"""Shot-sharded runs of the PyTorch/CUDA port (`qldpcsim_torch`) over the
CUDA cards of one host.

    python3 chip_mesh.py        # needs two cards or more

`chip_smoke.py` drives every path on one card, its meshes included (two
slots of one card, two processes sharing it). This script drives what only
several cards have:
  1. the cards' names and power limits; the six kernels built;
  2. the launch wrappers' device check on a real mismatch: kernel A and
     kernel B with their tensors on cuda:1 while cuda:0 is the current
     device raise, and launch once cuda:1 is current;
  3. one process, a mesh of the first k cards (k = 1, 2, 4, ... up to the
     card count; a host thread per card): the flagship (lp118_0, MS-L-50, p = 0.05) through
     `simulate_p` at 65,536 shots with the counters of the unmeshed run
     and kernel A once per chunk and card; then 1,048,576 shots, with
     4096-shot chunks (1024 per card on 4 cards) and with 4096 shots per
     card: warm shots/s beside the unmeshed run's;
  4. one process per card (`python3 -m qldpcsim_torch --mesh`, the
     launcher's environment set by this script, each rank owning the card
     of its local rank): the flagship at 1,048,576 shots, rank 0's counters
     equal to the one-process run's, each rank's launches counted, warm
     shots/s with `--batch 4096` and with 4096 shots per card; then the
     same command with no launcher environment, which starts one process
     per card itself (`qldpcsim_torch/parallel/launch.py`): its counters
     equal, one launch-count file per card (one per process), and its warm
     shots/s printed beside the one-process (thread) row and the launched
     row;
  5. config 4 (the Tanner code, MS-S-30, p = 0.01, 0.04, 0.07, 0.1, 32,768
     shots each) with `--mesh-p 2` over the same processes: per-p counters
     equal to the serial `simulate` on one card.
  6. the benchmark's multi-card configuration, `python3 bench_torch.py
     --config flagship_4card --chips N` (N the card count): it starts one
     process per card itself, 4096 shots a card and chunk, 4,194,304 shots
     a card; its line is `correct`, its check covers the first two chunks
     (every card's shots, against the CPU), each rank ran kernel A once a
     chunk, and its warm shots/s (from the slowest rank's window) is
     printed with the chunk's spans and the idle share of rank 0.

Every speed is printed beside the cards' names and power limits. The last
line is {"ok": true, "device": {...}}; any failed check raises and exits
non-zero.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

CODE = "lp118_0"
P_POINT, MAX_ITER, SCHEDULE, BATCH, SEED = 0.05, 50, "L", 4096, 0
SHOTS = 16 * BATCH
TIMED_SHOTS = 256 * BATCH
C4_FILES = ("data/Hx_T.npy", "data/Hz_T.npy")
C4_P = [0.01, 0.04, 0.07, 0.1]
C4_ITER, C4_SHOTS = 30, 8 * BATCH
RANK_TIMEOUT_S = 300
# phase 6: the benchmark's shots a card, and the seconds it may take (its
# check decodes two 4-card chunks on the CPU)
BENCH_SHOTS_A_CARD = 4 * 1024 * 1024
BENCH_TIMEOUT_S = 600
LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
               "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def check(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def cards_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    lines = out.stdout.strip().splitlines()
    return f"{len(lines)} x " + "; ".join(sorted(set(lines)))


def run_self(n, args, counts_path):
    """`python3 -m qldpcsim_torch ARGS` in one process with no launcher
    environment: it must start n ranks itself (one launch-count file per
    rank, rank n - 1 the last) and exit 0 within RANK_TIMEOUT_S. Its stdout
    and each rank's kernel launches."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.update(PYTHONPATH=HERE, QLDPC_LAUNCH_COUNTS=counts_path)
    p = subprocess.run([sys.executable, "-m", "qldpcsim_torch", *args,
                        "--quiet"], cwd=HERE, env=env, text=True,
                       capture_output=True, timeout=RANK_TIMEOUT_S)
    check(p.returncode == 0, f"--mesh alone: rc {p.returncode}\n"
          f"{p.stderr[-3000:]}")
    check(not os.path.exists(f"{counts_path}.{n}"),
          f"--mesh alone: no more than {n} ranks")
    launches = []
    for rank in range(n):
        with open(f"{counts_path}.{rank}") as f:
            launches.append(json.load(f))
    return p.stdout, launches


def run_ranks(n, args, counts_path):
    """`python3 -m qldpcsim_torch ARGS` on n ranks, one card each; each must
    exit 0 within RANK_TIMEOUT_S (every process is killed on the way
    out). Rank 0's stdout and each rank's kernel launches."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(n):
        env = dict(os.environ, PYTHONPATH=HERE, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(n), RANK=str(rank),
                   LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                   QLDPC_LAUNCH_COUNTS=counts_path)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "qldpcsim_torch", *args, "--quiet"],
            cwd=HERE, env=env, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=RANK_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f"rank {rank}: rc {p.returncode}\n{err[-3000:]}")
    launches = []
    for rank in range(n):
        with open(f"{counts_path}.{rank}") as f:
            launches.append(json.load(f))
    return outs[0][0], launches


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_mesh: needs two CUDA cards or more", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import qldpcsim_torch

    check(os.path.dirname(os.path.abspath(qldpcsim_torch.__file__))
          == os.path.join(HERE, "qldpcsim_torch"),
          "qldpcsim_torch must be the package beside chip_mesh.py")
    from qldpcsim_torch.codes import get_code
    from qldpcsim_torch.decoders import DecoderConfig, build_layers
    from qldpcsim_torch.engine.montecarlo import (
        ShotPipeline, SimConfig, simulate, simulate_p)
    from qldpcsim_torch.ops import _build, channel_cuda, ms_qc_cuda
    from qldpcsim_torch.ops.qc import detect_qc
    from qldpcsim_torch.parallel.keys import chunk_keys
    from qldpcsim_torch.parallel.mesh import make_mesh
    from qldpcsim_torch.utils.threefry import fold_in, prng_key

    t_start = time.perf_counter()
    n_cards = torch.cuda.device_count()
    cards = cards_line()
    kind = torch.cuda.get_device_name(0)

    def phase(name):
        print(f"--- {name} (at {time.perf_counter() - t_start:.1f} s)",
              flush=True)

    phase("1 cards and build")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {cards}")
    t0 = time.perf_counter()
    _build.load_all()
    print(f"built the six kernels in {time.perf_counter() - t0:.2f} s")

    code = get_code(CODE)
    Hx, Hz = np.asarray(code.Hx) % 2, np.asarray(code.Hz) % 2

    phase("2 the wrappers' device check on a real mismatch")
    torch.cuda.set_device(0)
    other = torch.device("cuda", 1)
    keys = chunk_keys(fold_in(prng_key(SEED, device=other), 0), 0, 4)
    dec = ms_qc_cuda.make_qc_decoder(
        detect_qc(Hz), DecoderConfig(dec_type="MS", max_iter=MAX_ITER,
                                     schedule=SCHEDULE),
        layers=build_layers(Hz, SCHEDULE), device=other)
    syn_T = torch.zeros((Hz.shape[0], 256), dtype=torch.float32,
                        device=other)
    before = (channel_cuda.LAUNCHES, ms_qc_cuda.LAUNCHES["MS"])
    for name, call in (
            ("kernel A", lambda: channel_cuda.sample_tiles_cuda(
                keys, P_POINT, Hx.shape[1], 64)),
            ("kernel B", lambda: ms_qc_cuda.ms_qc_cuda(dec, syn_T, 1.0))):
        try:
            call()
        except RuntimeError as exc:
            check("current device" in str(exc), f"{name}: {exc}")
            print(f"{name}, tensors on cuda:1, cuda:0 current: raised "
                  f"({exc})")
        else:
            raise RuntimeError(f"{name} launched on a card that is not "
                               "current")
        check((channel_cuda.LAUNCHES, ms_qc_cuda.LAUNCHES["MS"]) == before,
              f"{name}: nothing launched")
    torch.cuda.set_device(1)
    channel_cuda.sample_tiles_cuda(keys, P_POINT, Hx.shape[1], 64)
    ms_qc_cuda.ms_qc_cuda(dec, syn_T, 1.0)
    torch.cuda.synchronize(1)
    check((channel_cuda.LAUNCHES, ms_qc_cuda.LAUNCHES["MS"])
          == (before[0] + 1, before[1] + 1),
          "with cuda:1 current, kernels A and B launch on it")
    print("with cuda:1 current: kernels A and B launched")
    torch.cuda.set_device(0)

    ks = [k for k in (1, 2, 4, 8) if k <= n_cards]
    phase(f"3 one process, a mesh of {ks} cards")
    cfg = SimConfig(shots=SHOTS, dec_type="MS", dec_iterations=MAX_ITER,
                    dec_schedule=SCHEDULE, batch_size=BATCH, rng_seed=SEED,
                    device="cuda")
    ref = simulate_p(Hx, Hz, P_POINT, cfg)
    ref_timed = simulate_p(Hx, Hz, P_POINT, dataclasses.replace(
        cfg, shots=TIMED_SHOTS))
    print(f"unmeshed, cuda:0: counters {json.dumps(ref.counters)}; timed "
          f"{TIMED_SHOTS} shots: warm {ref_timed.shots_per_s_warm:.1f} "
          f"shots/s  [{cards}]")
    one_process = {}
    for k in ks:
        mesh = make_mesh([f"cuda:{i}" for i in range(k)])
        mcfg = dataclasses.replace(cfg, mesh=mesh)
        pipe = ShotPipeline(Hx, Hz, mcfg)
        a0 = channel_cuda.SYN_LAUNCHES
        r = simulate_p(Hx, Hz, P_POINT, mcfg, pipeline=pipe)
        check(channel_cuda.SYN_LAUNCHES - a0 == (SHOTS // BATCH) * k,
              f"{k} cards: kernel A once per chunk and card")
        check(r.counters == ref.counters
              and r.avg_iterations_x == ref.avg_iterations_x,
              f"{k} cards: counters equal the unmeshed run's")
        rates = []
        for batch in sorted({BATCH, BATCH * k}):
            bcfg = dataclasses.replace(mcfg, shots=TIMED_SHOTS,
                                       batch_size=batch)
            rt = simulate_p(Hx, Hz, P_POINT, bcfg,
                            pipeline=ShotPipeline(Hx, Hz, bcfg))
            check(rt.counters == ref_timed.counters,
                  f"{k} cards, chunks of {batch}: counters equal")
            rates.append(f"chunks of {batch} ({batch // k} a card): "
                         f"{rt.shots_per_s_warm:.1f}")
            one_process[(k, batch)] = rt.shots_per_s_warm
        print(f"{k} card(s), one process: counters equal; warm shots/s, "
              f"{TIMED_SHOTS} shots: " + ", ".join(rates) + f"  [{cards}]")

    phase(f"4 {n_cards} processes, one card each (--mesh)")
    flag = ["--code", CODE, "--p", str(P_POINT), "--decType", "MS",
            "--decSchedule", SCHEDULE, "--decIterations", str(MAX_ITER),
            "--rngSeed", str(SEED), "--shots", str(TIMED_SHOTS), "--mesh"]
    for batch in (BATCH, BATCH * n_cards):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "out.jsonl")
            t0 = time.perf_counter()
            stdout, launches = run_ranks(n_cards, [
                *flag, "--batch", str(batch), "--out", out],
                os.path.join(tmp, "launches"))
            secs = time.perf_counter() - t0
            with open(out) as f:
                row = json.loads(f.readline())
        check("SIMULATION RESULTS" in stdout, "rank 0 prints the table")
        check({k: row[k] for k in ref_timed.counters} == ref_timed.counters,
              f"{n_cards} processes, chunks of {batch}: rank 0's counters "
              "equal the one-process run's")
        for rank, la in enumerate(launches):
            check(la["channel syndromes"] == TIMED_SHOTS // batch
                  and la["ms_qc MS"] > 0,
                  f"rank {rank}: kernels A (once a chunk) and B launched")
        print(f"{n_cards} processes, chunks of {batch} ({batch // n_cards} "
              f"a card): counters equal; warm {row['shots_per_s_warm']:.1f}"
              f" shots/s on rank 0 (one process, one card: "
              f"{ref_timed.shots_per_s_warm:.1f}; {secs:.1f} s with the "
              f"processes' start); kernel A launches per rank "
              f"{[la['channel'] for la in launches]}  [{cards}]")
        # the same command line with no launcher around it: --mesh starts
        # one process per card itself
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "out.jsonl")
            t0 = time.perf_counter()
            stdout, launches_s = run_self(n_cards, [
                *flag, "--batch", str(batch), "--out", out],
                os.path.join(tmp, "launches"))
            secs_s = time.perf_counter() - t0
            with open(out) as f:
                row_s = json.loads(f.readline())
        check(stdout.count("SIMULATION RESULTS") == 1,
              "--mesh alone: one table, rank 0's")
        check({k: row_s[k] for k in ref_timed.counters}
              == ref_timed.counters,
              f"--mesh alone, chunks of {batch}: counters equal the "
              "one-process run's")
        for rank, la in enumerate(launches_s):
            check(la["channel syndromes"] == TIMED_SHOTS // batch
                  and la["ms_qc MS"] > 0,
                  f"--mesh alone, rank {rank}: kernels A and B launched")
        print(f"--mesh alone, chunks of {batch}: {len(launches_s)} "
              f"processes, counters equal; warm "
              f"{row_s['shots_per_s_warm']:.1f} shots/s on rank 0 "
              f"({secs_s:.1f} s with the processes' start), beside one "
              f"process with {n_cards} slot threads "
              f"{one_process[(n_cards, batch)]:.1f} and {n_cards} processes "
              f"launched here {row['shots_per_s_warm']:.1f}  [{cards}]")

    phase(f"5 config 4 with --mesh-p 2 over {n_cards} processes")
    files4 = [os.path.join(HERE, f) for f in C4_FILES]
    serial = simulate(files4[0], files4[1], C4_P, shots=C4_SHOTS,
                      decType="MS", decIterations=C4_ITER, decSchedule="S",
                      rngSeed=SEED)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.jsonl")
        _, launches = run_ranks(n_cards, [
            "--Hx", files4[0], "--Hz", files4[1], "--p",
            *[str(v) for v in C4_P], "--shots", str(C4_SHOTS), "--decType",
            "MS", "--decSchedule", "S", "--decIterations", str(C4_ITER),
            "--rngSeed", str(SEED), "--mesh-p", "2", "--out", out],
            os.path.join(tmp, "launches"))
        with open(out) as f:
            rows = [json.loads(line) for line in f]
    for row, r in zip(rows, serial):
        check({k: row[k] for k in r.counters} == r.counters,
              f"config 4 p={row['p']}: counters equal the serial sweep's")
        print(f"  p={row['p']}: counters equal; warm "
              f"{row['shots_per_s_warm']:.1f} shots/s (serial, one card: "
              f"{r.shots_per_s_warm:.1f})  [{cards}]")
    for rank, la in enumerate(launches):
        check(la["seq_qc MS"] > 0, f"rank {rank}: kernel D launched")

    phase(f"6 bench_torch.py --config flagship_4card on {n_cards} cards")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "lines.jsonl")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(HERE, "bench_torch.py"),
             "--config", "flagship_4card", "--chips", str(n_cards),
             "--shots", str(n_cards * BENCH_SHOTS_A_CARD), "--out", out],
            cwd=HERE, capture_output=True, text=True,
            timeout=BENCH_TIMEOUT_S)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"bench_torch.py: rc {proc.returncode}"
              f"\n{proc.stderr[-3000:]}")
        with open(out) as f:
            (line,) = [json.loads(ln) for ln in f]
    check(line["correct"] is True and line["chips"] == n_cards
          and line["batch"] == 4096 * n_cards,
          f"flagship_4card: correct, {n_cards} cards, 4096 shots a card")
    check(line["check"]["shots"] == 2 * line["batch"],
          "flagship_4card: the check covers two chunks, every card's shots")
    check(line["launches_per_chunk"].get("channel syndromes") == 1.0
          and line["launches_per_chunk"].get("ms_qc MS", 0) > 0,
          "flagship_4card: rank 0 ran kernel A once a chunk, and kernel B")
    lay = line["layers_ms_per_chunk"]
    print(f"flagship_4card, {n_cards} processes ({secs:.1f} s with their "
          f"start): {line['shots']} shots, warm "
          f"{line['shots_per_s_warm']:.1f} shots/s (the slowest rank's "
          f"window {line['warm_time_s']:.3f} s); correct "
          f"({line['check']['shots']} shots against the CPU); rank 0's "
          f"chunk: " + ", ".join(f"{k} {v:.4f}" for k, v in lay.items())
          + f" ms; idle share {line['idle_share']!r}; peak memory "
          f"{line['peak_mem_bytes']} bytes; decode bound share "
          f"{line['decode_bound_share']!r}; host {line['host_cpu']}  "
          f"[{cards}]")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(cards)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": n_cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
