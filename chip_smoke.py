#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`qldpcsim_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. toolchain: Python, torch and CUDA versions, nvcc, the card's name and
     power limit;
  2. build the six CUDA kernels from `qldpcsim_torch/csrc/*.cu` with nvcc,
     one process per source, all at once, with their register counts;
  3. kernel A (threefry depolarizing channel, the syndromes H e formed
     inside it) against its plain PyTorch version on the card: err_x,
     err_z, sy_z and sy_x bit-exact, and the errors-only variant, at
     p = 0.01, 0.05 and 1.0, on the chunks of lp118_0, the permuted
     lp118_0, the Tanner code (4096 shots each) and a random 6000 x 12,000
     matrix with a zero-weight row (2048 shots); on the flagship's chunk the
     device times of the fused launch, of the errors alone and of the
     parent's composition (errors, then `syndromes_of`'s float32
     products), with the host out of the way, the back-to-back call times,
     the plain version's, a lone call's microseconds, the bound and the
     integer-issue floor; the Tanner chunk's fused time beside its bound;
  4. kernel B, kind MS (min-sum over a circulant-lifted H), against its
     plain version on the card: 4096 flagship syndromes per side, 50
     iterations, layered and flooding schedules; e_hat, n_iter, converged
     and the posterior bit-exact; then, untimed and bit-exact too, lp04_0
     (lift 7, degree 7) and the Tanner code (lift 31), a lone shot, a batch
     that does not fill its last block, zero syndromes (one iteration),
     p = 0.2 (most shots at the cap), synthetic lifted codes with a
     non-uniform degree and with degree 12, under their own layers, under
     layer groups that need a snapshot and under flooding, both mappings (a
     thread per check row, a thread per edge) and the state in device
     memory, forced on small codes; then the kernel's time under the
     mapping its tables choose and under the other one at the flagship's
     shapes (the cascade's head, second stage and last stage, the full
     depth) and a lone shot's microseconds per iteration;
  5. kernel B, kind BP (tanh-product sum-product), against its plain
     version on the card: 4096 syndromes per side at p = 0.03, flooding, 99
     iterations; e_hat, n_iter, converged and the posterior bit-exact; the
     other shapes, mappings and times as in phase 4;
  6. kernel C (GF(2) elimination of OSD) against its plain version on the
     card: a 256-shot window of lp118_0 column orders, the decoder-failed
     shots of a BP decode at p = 0.05 in the port's reliability order,
     topped up with random orders; tags, pivots and sel bit-exact under
     both mappings of the back-elimination (a thread per basis row, a
     thread per (row, word) pair), each timed on the window and on a lone
     shot, in microseconds per column, the lone shot beside its bound; and
     a 1200 x 2400 parity-check matrix whose basis lies in device memory,
     a 256-shot window of random orders, bit-exact under both mappings and
     each timed;
  7. the flagship path: `simulate_p` on lp118_0 (normalized min-sum,
     layered, 50 iterations, p = 0.05, 4096-shot chunks, 65,536 shots) on
     the card, with the launch counts of its kernels and its qBLER held to
     the 0.04516602 of earlier runs, a timed run of 1,048,576 shots (a warm
     window of about a second), then a CUDA-event breakdown of a chunk into
     channel, decode X, decode Z and classify;
  8. the flagship's first two chunks through the port on the CPU (plain
     versions) against the same chunks on the card: all 9 counters equal;
  9. config 5: `simulate_p` on lp118_0 (BP, flooding, 99 iterations, OSD-2,
     p = 0.03, 4096-shot chunks, 65,536 shots) on the card, with the
     launch counts of its kernels and the shots that reached OSD, a timed
     run of 1,048,576 shots, then a
     CUDA-event breakdown of a chunk into channel, decode X, decode Z, OSD
     and classify;
 10. config 5's first two chunks on the CPU against the card: both counter
     sets, the shots whose final estimates differ (BP's tanh and log may
     round differently in the last ulp on the two devices), and qBLER
     within 4 sigma;
 11. kernel D, kind MS (serial min-sum over a circulant-lifted H), against
     its plain version on the card, Tanner code, both sides, syndromes from
     the port's channel at p = 0.07: 4096 shots at the cascade head's 4
     iterations, and a 128-shot window at the full 30 iterations on side X;
     side X's 4096 shots against the row-by-row plain version (~50 small
     launches per check row), side Z and the window against the block-row
     formulation in plain PyTorch, which is what the kernel runs; n_iter,
     converged and e_hat equal, the posterior equal by value; the kernel
     alone is also timed at 4096 shots and 30 iterations, and a lone shot
     per iteration; then, untimed, against both plain versions: lp04_0,
     lp118_0, a lone shot, a batch that does not fill its last block, zero
     syndromes (n_iter 1), p = 0.2, the synthetic lifted codes, and the
     state in device memory forced on small codes;
 12. kernel D, kind BP: the same comparison;
 13. config 4: `simulate` on the Tanner code files (min-sum, serial, 30
     iterations, p = 0.01, 0.04, 0.07, 0.1, 32,768 shots each, seed 0) on
     the card; per p the counters, qBLER, iterations, warm shots/s,
     launches, the cascades' full-depth launches and host syncs (none),
     and a timed run long enough for a warm window of about a second; for
     p = 0.01 and 0.1 a CUDA-event breakdown of a chunk;
     then the same entry point with BP on 2 chunks, which drives kernel D's
     BP kind;
 14. config 4's first 1024 shots at p = 0.04 (one chunk of that size) on
     the CPU against the card: all 9 counters equal;
 15. kernel E, kind MS (min-sum over any H with contiguous layers), against
     its plain version on the card, on matrices with no circulant lift:
     lp118_0 with one seeded column permutation on both sides (the
     flagship's code up to a relabelling of qubits), side X, syndromes from
     the port's channel at p = 0.05, layered and flooding, at the cascade's
     shapes (4096 shots at 4 iterations, the head's unconverged shots, at
     most 512, at 10, a 128-shot tail window at the full 50), the full depth (4096 at 50) and a lone shot's
     microseconds per iteration; bicycle (73 one-row layers, row weight 18)
     and a seeded row-irregular 240 x 544 matrix (row weights 3 to 8),
     layered, 4096 shots at 4 iterations; zero syndromes and p = 0.2; every
     shape under the mapping the tables choose and the other one (a thread
     per edge, a thread per check row), each with the state in shared and
     in device memory, timed, and n_iter, converged and e_hat equal to the
     plain version's and the posterior equal by value; the lone shot beside
     its bound;
 16. kernel E, kind BP: the same comparison;
 17. the non-QC main path: `simulate_p` on the permuted lp118_0 (min-sum,
     layered, 50 iterations, p = 0.05, 4096-shot chunks, 65,536 shots,
     impl "auto") on the card, with its launch counts (kernel E, neither QC
     kernel); its qBLER within 4 sigma of the flagship's from phase 7; a
     timed run of 1,048,576 shots (a warm window of about a second); a
     CUDA-event breakdown of a chunk into channel, decode X, decode Z and
     classify, with each side's cascade stages; `simulate` on the same
     matrices as .npy files; and the same path with BP forced onto kernel E
     on 2 chunks;
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
     timed beside the incidence decoder that the routing gives them;
 21. kernel F (slot-stacked flooding over a circulant-lifted H), kinds MS
     and BP, against its plain version on the card: lp118_0 side X at
     p = 0.03, 4096 shots at 99 iterations (config 5's shape) and at the
     cascade head's 4, and a 128-shot tail window at 99; the Tanner code
     side X, 4096 shots at 30 iterations; lp04_0 (block-row degree 7), 4096
     shots at 30; n_iter, converged and e_hat equal, the posterior equal by
     value; at config 5's shape also with a thread per variable
     (max(m, n) threads) in place of the plan's block; beside it kernel B
     on the same syndromes: both times, a lone shot's time per iteration
     for both (kernel F with both blocks, beside its bound), and the shots
     whose decisions differ between the two kernels;
 22. kernel B with the convergence check after every layer group against
     its plain version, MS and BP, lp118_0 layered, 4096 shots at 50
     iterations, bit-exact, timed beside the per-iteration check; the other
     shapes and mappings of phase 4 with this check;
 23. the command line: config 5 through `qldpcsim_torch.cli.main` (BP,
     flooding, 99 iterations, OSD-2, p = 0.03, 65,536 shots, seed 0) with
     kernel F opted in (QLDPC_QC_STACKED=1) and the group-level OSD pass:
     launch counts (kernel F, kind BP, and kernel C; kernel B none), warm
     shots/s beside phase 9's, qBLER within 4 sigma of phase 9's; CUDA-event
     breakdowns of a chunk with OSD in the chunk and with the group-level
     pass, each with its host syncs and kernel C launches; the first two
     chunks on the CPU against the card, qBLER within 4 sigma; the same
     entry point with --decType MS (flooding, 50 iterations, p = 0.05):
     kernel F, kind MS, launched, and the counters of the first two chunks
     equal on the card and the CPU; one run of `python3 -m qldpcsim_torch`
     in a process of its own (4096 shots), its table and --out file parsed;
 24. `validate_encoding=True` on the flagship's first two chunks: counters
     equal to phase 8's; one call of each `compat` decoder shim on the card;
 25. kernel B with the bf16 state (QLDPC_QC_DTYPE=bf16) against its plain
     bf16 version, bit for bit: MS-L-50 at the flagship's shape (lp118_0
     side X, 4096 shots, p = 0.05), MS-F-99 and BP-F-99 at config 5's,
     MS-L-50 with the check after every layer group, and a synthetic lift
     whose state lies in device memory in bf16 too; each timed beside the
     float32 kernel, with the shared memory per shot and the blocks per SM
     of both (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
 26. kernel F with the bf16 state against its plain bf16 version, MS and
     BP at config 5's shape, timed beside float32, and a lift that kernel F
     takes only in bf16 (float32: kernel B, state in device memory);
 27. kernel B with the stacked-update writeback (QLDPC_QC_VEC=1) against
     its plain version, MS-L-50 and MS-F-50 on lp118_0, both mappings and
     both places of the state, timed beside the per-slot writeback, and the
     shots whose decisions differ from it;
 28. the main paths with the variants, through `simulate_p` (65,536 shots
     each, the flags in the environment when the pipeline is built): the
     flagship in bf16, config 5 in bf16 on kernel B and with
     QLDPC_QC_STACKED=1 on kernel F, MS-F-50 in bf16 on kernel F, and the
     flagship with the writeback; each with its decoder choice, its
     launches (kernel A fused once a chunk, the variant's own count), qBLER
     within 4 sigma of the float32 run's, a timed run of 1,048,576 shots,
     and its first chunks on the CPU (plain versions) against the card:
     counters equal for MS (two chunks), qBLER within 4 sigma for BP (one
     chunk); the writeback's
     first chunks beside the default run's (phase 8);
 29. the group-deferred cascade (`engine/group_cascade.py`, each pipeline
     built with QLDPC_GROUP_CASCADE=1): counters and average iterations
     equal to the in-chunk cascade's on the same shots, for the flagship
     (phase 7's), config 4 at p = 0.01 and 0.1 (phase 13's) and config 5
     on kernels F and C (QLDPC_QC_STACKED=1, the run without the gate in
     this phase); for each path and its in-chunk twin the launches and
     host syncs (torch.nonzero) per chunk, the head stages' lanes, the
     deferred records, the overflowed chunks and the tail's lanes and
     windows; warm shots/s with and without the gate in turns, each window
     about a second (the flagship on 1,048,576 shots three times, config 4
     at p = 0.1 on 131,072 twice, config 5 on kernel F on 1,048,576
     twice); a CUDA-event breakdown of a chunk with the stragglers'
     torch.nonzero, their record gathers and the group finish each as its
     own span, and the card's idle gaps between launches as the residual;
 30. the native GF(2) core (`gf2/native.py`) built on the card's host into
     the port's build directory; rank and rref of phase 6's 1200 x 2400
     matrix equal to the numpy path's (QLDPC_NATIVE=0), each timed on the
     host; ShotPipeline construction of the flagship and config 4 timed
     with and without it;
 31. the benchmark entry point, `bench_torch.py`, in this process, for the
     flagship and config 5 on kernel F at 262,144 shots: each line parses
     and is `correct` (its first 8192 shots against the plain versions on
     the CPU), and its counters and iterations equal those of the same
     shots through phase 7's pipeline and through phase 23's command line
     (kernel F opted in); warm shots/s, the chunk's spans, launches, host
     syncs, idle share and peak memory printed; then `bench_torch.py`'s
     layer pass on pipelines built with QLDPC_GROUP_CASCADE=1, the flagship
     and config 4 at p = 0.1 (every chunk overflows), 32,768 shots each:
     decode X, decode Z (the head and tail decoders) and the group finish
     above zero, and the residual smaller than with the spans on the
     pipeline's own cascades, which read zero there;
 32. the parity harness, `parity_torch.py`, in this process: first a
     control that must fail (row 5b_lp118_ms_osd2 with the engine's X
     estimates zeroed), then the ten rows of BASELINE configs 1-5 with
     every launch count at 0 just before, the engine (`simulate_p` on the
     card) at 16,384 shots a row, the oracle on the host (the native C++
     core for MS and BP with OSD, numpy for BF and NG) at a fifth of its
     shots; every row within 4 sigma, each row's seconds on both sides,
     and kernels A, B (MS and BP), C and D (MS) launched by the rows;
 33. the straggler cascade on kernel B: the full-depth path (one launch a
     side) against the stages (the tail compacted and decoded in windows
     on the host), both sides of a chunk, MS-L-50 at p = 0.05 and BP-F-99
     at p = 0.03 on lp118_0, 8 chunks of the flagship's keys: results
     equal bit for bit; per path, in turns, the wall ms a chunk, the host
     ms from call to return, host syncs, launches and the card's busy ms a
     chunk (kernel B's among them, from `torch.profiler`);
 M1. the flagship on a 2-slot mesh of cuda:0 in this process (a host thread
     per slot, 2048 shots each a chunk): counters equal to phase 7's, kernel
     A launched once per chunk and slot, warm shots/s beside phase 7's and a
     timed run of 1,048,576 shots beside phase 7's;
 M2. two processes sharing cuda:0, started as `python3 -m qldpcsim_torch`
     with the launcher's environment (MASTER_ADDR, a free MASTER_PORT,
     WORLD_SIZE 2, RANK and LOCAL_RANK 0 and 1), each with a timeout, each
     rank's launches read from QLDPC_LAUNCH_COUNTS: (a) the flagship with
     --mesh, rank 0's counters equal to phase 7's; (b) config 4 with
     --mesh-p 2, per-p counters equal to phase 13's; (c) config 5 with
     --mesh, counters equal to phase 9's (kernels B, BP, and C, each rank
     with its own group-level OSD pass); (d) the host microseconds of one
     counter all-reduce over gloo between two ranks. Two slots or ranks on
     one card show no scaling; `chip_mesh.py` runs the meshes of several
     cards.

Each kernel's bound is the larger of its bytes (inputs read once, outputs
written once) over the card's 3.35 TB/s and its operations over 67 Top/s
(the float32 rate outside the tensor cores; integer work is counted against
the same rate, the table of peaks having none for it), for the iterations
and columns this run's data needed; kernel A's integer-issue floor (its
operations over the INT32 lanes) is printed beside it. Every main path
checks that each of its chunks ran kernel A once, with the syndromes
formed inside it. No single PyTorch call computes any of
the kernels' functions, so `library_ms` is null throughout.

The last two lines are the kernels' JSON summary and
{"ok": true, "device": {...}}. Exits non-zero, printing neither, when torch
sees no CUDA device or the package is not beside this script.
"""

import dataclasses
import json
import math
import os
import socket
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
# the cross-check's shots, one chunk: the first quarter of the first chunk's
# tiles (the CPU walks 465 check rows per iteration, one at a time, and a
# whole chunk of 4096 took it 28 to 47 s)
C4_CROSS_SHOTS = BATCH // 4
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
OPS_EDGE = 3   # a syndrome edge: the column's word, its shift, the XOR
# the INT32 lanes of an H100 SXM: 132 SMs x 64 a clock at the 1.98 GHz boost
INT32_OPS_S = 132 * 64 * 1.98e9
# kernel A's large .npy code: a random (BIG_N / 2) x BIG_N matrix
BIG_N = 12000
BIG_SEED = 12
# the host's lead over the card when a kernel is timed alone (device_ms)
SLEEP_CYCLES = 20_000_000
# the timed runs: enough shots for a warm window of a second or more
TIMED_SHOTS = 256 * BATCH          # the flagship and config 5
C4_TIMED_SHOTS = [256 * BATCH, 128 * BATCH, 64 * BATCH, 32 * BATCH]  # per p
# phase 31: bench_torch.py's shots per configuration, and the shots of the
# layer passes under the group cascade
BENCH_SHOTS = 64 * BATCH
GC_SPAN_SHOTS = 8 * BATCH
# phase 32: parity_torch.py's rows at reduced counts (engine shots, the
# factor on the oracle's)
PARITY_ENGINE_SHOTS = 4 * BATCH
PARITY_SCALE = 0.2
PARITY_CONTROL = "5b_lp118_ms_osd2"
# phase 33: the chunks of the cascade's two paths' comparison
CASCADE_CHUNKS = 8
# M2: the seconds a rank may take before the phase fails
RANK_TIMEOUT_S = 240
# M2d: two ranks time the counter all-reduce (9 counters, and 2 p-rows)
ALLREDUCE_PROBE = """
import json, time
import torch
from qldpcsim_torch.parallel.mesh import allreduce_counters_host, multihost_init
assert multihost_init(timeout_s=120)
reps, out = 2000, {}
for name, shape in (("us_9", (9,)), ("us_rows", (2, 9))):
    t = torch.ones(shape, dtype=torch.int64)
    for _ in range(50):
        allreduce_counters_host(t)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        s = allreduce_counters_host(t)
    out[name] = (time.perf_counter() - t0) / reps * 1e6
    assert int(s.sum()) == 2 * t.numel()
print(json.dumps(dict(out, reps=reps)))
"""
# kernels B, D and E with one thread per shot and the state in device
# memory, as measured before their redesign (NVIDIA H100 80GB HBM3, 700 W;
# PERF.md)
OLD = {
    "B MS L 4096x50 ms": 31.759, "B BP F 4096x99 ms": 91.677,
    "B MS lone us/it": 289.2, "B BP lone us/it": 563.7,
    "D MS 4096x4 ms": 9.876, "D BP 4096x4 ms": 12.127,
    "D MS 4096x30 ms": 60.451, "D MS lone us/it": 531.2,
    "D BP lone us/it": 1017.7,
    "flagship shots/s": 47523.4, "config 5 shots/s": 17328.2,
    "config 4 shots/s": [249639.1, 35319.2, 11804.8, 4749.5],
    # kernel E with one thread per shot and the state in device memory
    "E MS L 4096x4 ms": "5.2359 ms", "E MS F 4096x4 ms": "not recorded",
    "E BP L 4096x4 ms": "6.2801 ms", "E BP F 4096x4 ms": "not recorded",
    "E MS L 4096x50 ms": "44.106 ms", "E MS F 4096x50 ms": "72.266 ms",
    "E BP L 4096x50 ms": "not recorded", "E BP F 4096x50 ms": "not recorded",
    "E MS lone us/it": 427.2, "E BP lone us/it": 738.6,
    "non-QC shots/s": 34668.0,
    # kernels C and F before their redesign (one warp per shot; three passes
    # per iteration with a thread per check row)
    "C 256-window ms": 0.9418, "F MS 4096x99 ms": 0.2574,
    "F BP 4096x99 ms": 0.3695, "F MS lone us/it": 2.141,
    "F BP lone us/it": 3.0,
    # kernel A before its redesign: the errors alone, a thread per element
    "A 4096x544 ms": "0.0645-0.0996 ms",
}


def synthetic_lift(name):
    """Lifted codes the library has none of: block-rows of degrees 2 to 5
    (`irregular`), a uniform degree of 12 (`deg12`), and 60 block-rows of
    degree 14 over 120 variable blocks of lift 64 (`oversize`)."""
    import numpy as np

    from qldpcsim_torch.ops.qc import QCStructure

    rng = np.random.default_rng(21)
    if name == "irregular":
        L, m_b, n_b, degs = 9, 6, 10, [2, 5, 3, 4, 5, 2]
    elif name == "deg12":
        L, m_b, n_b, degs = 8, 3, 14, [12, 12, 12]
    else:   # "oversize": a state beyond a block's shared memory, bf16 too
        L, m_b, n_b, degs = 64, 60, 120, [14] * 60
    shifts = np.full((m_b, n_b), -1)
    for i, d in enumerate(degs):
        shifts[i, rng.choice(n_b, d, replace=False)] = rng.integers(0, L, d)
    return QCStructure(L=L, shifts=shifts)


def bf16_only_lift():
    """A lift (L 128, 27 x 8 blocks, degree 8) whose float32 state needs
    device memory under kernel B and is too large for kernel F, while its
    bf16 state fits a block in both."""
    import numpy as np

    from qldpcsim_torch.ops.qc import QCStructure

    L, m_b, n_b, deg = 128, 27, 8, 8
    shifts = np.full((m_b, n_b), -1)
    for i in range(m_b):
        shifts[i, [(3 * i + t) % n_b for t in range(deg)]] = [
            (i + 2 * t) % L for t in range(deg)]
    return QCStructure(L=L, shifts=shifts)


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


def device_ms(fn, reps):
    """Mean milliseconds of fn() on the card with the host out of the way:
    a sleep kernel holds the stream while the host enqueues all `reps`
    calls, so the events time the launches back to back. The sleep grows
    until the host has enqueued every call before it ends."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = SLEEP_CYCLES
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        ahead = not start.query()
        end.synchronize()
        if ahead:
            return start.elapsed_time(end) / reps
        cycles *= 4
    raise RuntimeError("the host did not get ahead of the card")


def bound(n_bytes, n_ops):
    """(least milliseconds the card could take, which side bounds it)."""
    t_bytes = 1e3 * n_bytes / PEAK_BYTES_S
    t_ops = 1e3 * n_ops / PEAK_OPS_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def breakdown(pipe, p, names, smi, chunks=BREAKDOWN_CHUNKS, p_index=0,
              stages=False):
    """Mean CUDA-event milliseconds of the spans of a chunk over `chunks`
    chunks of the key branch `p_index` (not part of any launch count); with
    `stages`, also each cascade stage's decoder calls per side (the launch
    and the transposes around it)."""
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
    pending, stage_ms, wrapped = [], {}, []
    if stages:
        for side, casc in (("X", pipe.dec_x), ("Z", pipe.dec_z)):
            for i, d in enumerate(casc.decs):
                stage_ms[(side, i)] = [0.0, 0]

                def timed(*args, _f=d.forward, _k=(side, i)):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    r = _f(*args)
                    e1.record()
                    pending.append((_k, e0, e1))
                    return r

                d.forward = timed
                wrapped.append(d)
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
        for k, e0, e1 in pending:
            stage_ms[k][0] += e0.elapsed_time(e1)
            stage_ms[k][1] += 1
        pending.clear()
        check(int(counts["decSuccessExact"]) <= BATCH, "breakdown counts")
    for d in wrapped:
        del d.forward
    spans /= chunks
    total = spans.sum()
    parts = ", ".join(f"{nm} {s:.4f} ({100 * s / total:.1f}%)"
                      for nm, s in zip(names, spans))
    print(f"  chunk breakdown (CUDA events, mean of {chunks} "
          f"chunks, ms): {parts}, total {total:.4f}  [{smi}]")
    if stages:
        for side in ("X", "Z"):
            casc = pipe.dec_x if side == "X" else pipe.dec_z
            print(f"  cascade stages, side {side} (iterations, window): ms "
                  f"per chunk and calls per chunk: " + ", ".join(
                      f"{casc.stages[i]} {v[0] / chunks:.4f} ms, "
                      f"{v[1] / chunks:.2f} calls"
                      for (sd, i), v in stage_ms.items() if sd == side)
                  + f"  [{smi}]")


def cascade_paths(smi, chunks=CASCADE_CHUNKS, rounds=2):
    """Phase 33: the straggler cascade on kernel B, the full-depth path
    (`Cascade.forward_full`) against the stages (`forward_stages`), both
    sides of a chunk, for the benchmark's two decoders on lp118_0 (MS-L-50
    at p = 0.05, BP-F-99 at p = 0.03). On `chunks` chunks of the flagship's
    keys: the results of both paths equal bit for bit, then per path, in
    turns (stages, full, full, stages, `rounds` times): the wall ms a chunk
    (host clock around all chunks, ending in a sync), the host ms from the
    call to the return of both sides (the card idle at each call), the
    cascades' host syncs and kernel-B launches, and under `torch.profiler`
    the kernels launched and the card's busy ms a chunk, kernel B's among
    them."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qldpcsim_torch.codes import get_code
    from qldpcsim_torch.engine.montecarlo import ShotPipeline, SimConfig
    from qldpcsim_torch.ops import ms_qc_cuda
    from qldpcsim_torch.parallel.keys import chunk_keys
    from qldpcsim_torch.utils.threefry import fold_in, prng_key

    code = get_code(CODE)
    Hx, Hz = np.asarray(code.Hx) % 2, np.asarray(code.Hz) % 2
    tpc = BATCH // 64
    for label, kind, sched, cap, p in (
            ("MS-L-50", "MS", "L", 50, P_POINT),
            ("BP-F-99", "BP", "F", 99, C5_P)):
        cfg = SimConfig(shots=chunks * BATCH, dec_type=kind,
                        dec_iterations=cap, dec_schedule=sched,
                        batch_size=BATCH, rng_seed=SEED, device="cuda")
        pipe = ShotPipeline(Hx, Hz, cfg)
        sides = (pipe.dec_x, pipe.dec_z)
        check(all(d.full_depth for d in sides),
              f"33 {label}: both cascades take the full-depth path")
        key = fold_in(prng_key(SEED, device=pipe.device), 0)
        syns = [pipe._sample_chunk(chunk_keys(key, ci * tpc, tpc), p)[2:]
                for ci in range(chunks)]
        prior = np.float32(p) / np.float32(3.0)

        def run(path, timed=None):
            out = []
            for sz, sx in syns:
                if timed is not None:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                out.append([getattr(d, "forward_" + path)(s, prior)
                            for d, s in ((pipe.dec_x, sz), (pipe.dec_z, sx))])
                if timed is not None:
                    timed.append(time.perf_counter() - t0)
            return out

        same = True
        for a, b in zip(run("full"), run("stages")):
            for ra, rb in zip(a, b):
                same &= all(torch.equal(getattr(ra, f), getattr(rb, f))
                            for f in ("e_hat", "n_iter", "converged",
                                      "posterior"))
        check(same, f"33 {label}: the full-depth path equals the stages, "
              "bit for bit")
        stats = {"stages": [], "full": []}
        for _ in range(rounds):
            for path in ("stages", "full", "full", "stages"):
                syncs0 = sum(d.syncs for d in sides)
                b0 = ms_qc_cuda.LAUNCHES[kind]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(path)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / chunks
                enq = []
                run(path, timed=enq)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    run(path)
                    torch.cuda.synchronize()
                kern = [e for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and not e.name.startswith(("Memcpy", "Memset"))]
                b_us = sum(e.time_range.elapsed_us() for e in kern
                           if "ms_qc_kernel" in e.name)
                stats[path].append({
                    "wall_ms": 1e3 * wall,
                    "enqueue_ms": 1e3 * float(np.mean(enq)),
                    # both sides, over the three passes above
                    "syncs": (sum(d.syncs for d in sides) - syncs0)
                    / (3 * chunks),
                    "b_launches": (ms_qc_cuda.LAUNCHES[kind] - b0)
                    / (3 * chunks),
                    "launches": len(kern) / chunks,
                    "busy_ms": sum(e.time_range.elapsed_us() for e in kern)
                    / 1e3 / chunks,
                    "kernel_b_ms": b_us / 1e3 / chunks})
        for path, runs_ in stats.items():
            med = {k: float(np.median([r[k] for r in runs_]))
                   for k in runs_[0]}
            print(f"  {label} {path}: a chunk (both sides, median of "
                  f"{len(runs_)} runs of {chunks} chunks): wall "
                  f"{med['wall_ms']:.4f} ms, host from call to return "
                  f"{med['enqueue_ms']:.4f} ms, card busy "
                  f"{med['busy_ms']:.4f} ms (kernel B "
                  f"{med['kernel_b_ms']:.4f} in {med['b_launches']:.2f} "
                  f"launches), {med['launches']:.2f} launches, "
                  f"{med['syncs']:.2f} host syncs; runs: " + "; ".join(
                      f"{r['wall_ms']:.4f}/{r['enqueue_ms']:.4f}/"
                      f"{r['busy_ms']:.4f}" for r in runs_) + f"  [{smi}]")
        check(all(r["syncs"] == 0 and r["b_launches"] == 2
                  for r in stats["full"]),
              f"33 {label}: no cascade sync, one kernel-B launch a side")


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
    from qldpcsim_torch.channel.depolarizing import syndromes_of
    from qldpcsim_torch.codes import get_code
    from qldpcsim_torch.decoders import (
        DecoderConfig, TannerGraph, build_layers, make_decoder)
    from qldpcsim_torch.decoders.osd import OSD, reliability_order
    from qldpcsim_torch.engine.montecarlo import (
        ShotPipeline, SimConfig, simulate, simulate_p)
    from qldpcsim_torch.engine.results import PPointResult
    from qldpcsim_torch.ops import (
        _build, channel_cuda, flood_qc_cuda, general_h_cuda, gf2_elim_cuda,
        ms_qc_cuda, seq_qc_cuda)
    from qldpcsim_torch.ops.channel_cuda import SyndromeTables
    from qldpcsim_torch.ops.qc import detect_qc
    from qldpcsim_torch.parallel.keys import chunk_keys
    from qldpcsim_torch.parallel.mesh import make_mesh
    from qldpcsim_torch.utils.threefry import fold_in, prng_key

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()

    def reset_launches():
        channel_cuda.LAUNCHES = 0
        channel_cuda.SYN_LAUNCHES = 0
        gf2_elim_cuda.LAUNCHES = 0
        ms_qc_cuda.VEC_LAUNCHES = 0
        for k in ms_qc_cuda.LAUNCHES:
            ms_qc_cuda.LAUNCHES[k] = 0
            ms_qc_cuda.BF16_LAUNCHES[k] = 0
            flood_qc_cuda.BF16_LAUNCHES[k] = 0
            seq_qc_cuda.LAUNCHES[k] = 0
            general_h_cuda.LAUNCHES[k] = 0
            flood_qc_cuda.LAUNCHES[k] = 0

    def read_launches():
        return {"channel": channel_cuda.LAUNCHES,
                "ms_qc MS": ms_qc_cuda.LAUNCHES["MS"],
                "ms_qc BP": ms_qc_cuda.LAUNCHES["BP"],
                "gf2_elim": gf2_elim_cuda.LAUNCHES,
                "seq_qc MS": seq_qc_cuda.LAUNCHES["MS"],
                "seq_qc BP": seq_qc_cuda.LAUNCHES["BP"],
                "general_h MS": general_h_cuda.LAUNCHES["MS"],
                "general_h BP": general_h_cuda.LAUNCHES["BP"],
                "flood_qc MS": flood_qc_cuda.LAUNCHES["MS"],
                "flood_qc BP": flood_qc_cuda.LAUNCHES["BP"]}

    def check_fused(la, label):
        """Every channel launch since the counts were reset formed its
        chunk's syndromes too (read right after `read_launches`)."""
        print(f"  {label}: channel launches {la['channel']}, of which with "
              f"the syndromes formed inside {channel_cuda.SYN_LAUNCHES}")
        check(la["channel"] > 0 and channel_cuda.SYN_LAUNCHES == la["channel"],
              f"{label}: every chunk's channel is one fused launch")

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
    sources = _build.SOURCES
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

    tanner = get_code("tanner")
    Tx = np.asarray(tanner.Hx) % 2
    Tz = np.asarray(tanner.Hz) % 2
    nT = Tx.shape[1]

    # 3. kernel A against its plain version: the fused launch (the errors
    # and both syndromes) on the main paths' codes and a large .npy code,
    # then the errors alone
    phase("3 kernel A (channel, syndromes formed inside it)")
    key = fold_in(prng_key(SEED, device=dev), 0)
    keys = chunk_keys(key, 0, BATCH // 64)
    perm = np.random.default_rng(GH_PERM_SEED).permutation(n)
    rngA = np.random.default_rng(BIG_SEED)
    big = np.zeros((BIG_N // 2, BIG_N), np.int8)
    for i in range(big.shape[0]):
        big[i, rngA.choice(BIG_N, int(rngA.integers(10, 21)),
                           replace=False)] = 1
    big[7] = 0    # a check of weight 0
    worst_a = 0.0
    for label, Ax, Az, B_ in (
            (CODE, Hx, Hz, BATCH),
            (f"permuted {CODE}", Hx[:, perm], Hz[:, perm], BATCH),
            ("tanner", Tx, Tz, BATCH),
            (f"random {big.shape[0]} x {BIG_N}, rows of 10 to 20",
             big[::-1], big, BATCH // 2)):
        tabs_ = SyndromeTables.build(Ax, Az, device=dev)
        keys_ = chunk_keys(key, 0, B_ // 64)
        nA = Ax.shape[1]
        for p in (0.01, P_POINT, 1.0):
            out = channel_cuda.sample_shot_tiles_cuda(keys_, p, nA, 64, tabs_)
            ex, ez = channel_cuda.sample_tiles_cuda(keys_, p, nA, 64)
            plain = channel_cuda.sample_shot_tiles_plain(keys_, p, nA, 64,
                                                         tabs_)
            torch.cuda.synchronize()
            check(out[0].shape == (B_, nA)
                  and out[2].shape == (B_, Az.shape[0])
                  and out[3].shape == (B_, Ax.shape[0]),
                  f"channel shapes {[tuple(o.shape) for o in out]}")
            diffs = [int((a != b).sum()) for a, b in
                     zip(out + (ex, ez), plain + plain[:2])]
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(out, plain))
            worst_a = max(worst_a, err)
            print(f"channel {label}, B={B_}, p={p}: {int(out[0].sum())} X, "
                  f"{int(out[1].sum())} Z errors, {int(out[2].sum())} + "
                  f"{int(out[3].sum())} syndrome bits; elements differing "
                  f"from plain (err_x, err_z, sy_z, sy_x; errors-only "
                  f"err_x, err_z): {diffs}")
            check(sum(diffs) == 0, f"kernel A == plain: {label}, p={p}")

    tabs = SyndromeTables.build(Hx, Hz, device=dev)

    def fused():
        return channel_cuda.sample_shot_tiles_cuda(keys, P_POINT, n, 64,
                                                   tabs)

    def errors_only():
        return channel_cuda.sample_tiles_cuda(keys, P_POINT, n, 64)

    def composition():
        """The parent's channel as the engine ran it: the errors, then the
        float32 syndrome products."""
        ex, ez = channel_cuda.sample_tiles_cuda(keys, P_POINT, n, 64)
        return syndromes_of(ex, ez, Hx_T, Hz_T)

    out = fused()
    draws = out[0].numel()
    edges = BATCH * (tabs.z.cols.numel() + tabs.x.cols.numel())
    # the function's inputs: the keys and each H's columns (CSR)
    a_bound = bound(nbytes(keys, *out, tabs.z.rp, tabs.z.cols, tabs.x.rp,
                           tabs.x.cols), draws * OPS_DRAW + OPS_EDGE * edges)
    print(f"channel bound inputs: {draws} draws x {OPS_DRAW} + {edges} "
          f"syndrome edges x {OPS_EDGE} operations; integer-issue floor "
          f"{1e3 * (draws * OPS_DRAW + OPS_EDGE * edges) / INT32_OPS_S:.6f}"
          f" ms (the INT32 lanes: 132 SMs x 64 a clock at 1.98 GHz)")
    a_ms = device_ms(fused, 50)
    e_ms = device_ms(errors_only, 50)
    comp_ms = device_ms(composition, 50)
    a_call, comp_call = cuda_ms(fused, 50), cuda_ms(composition, 50)
    a_plain = cuda_ms(lambda: channel_cuda.sample_shot_tiles_plain(
        keys, P_POINT, n, 64, tabs), 10)
    lone, enqueue, enqueue_e = [], [], []
    for _ in range(21):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused()
        enqueue.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        lone.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        errors_only()
        enqueue_e.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    print(f"channel ({BATCH // 64} tiles x 64 x {n}, both syndromes), device "
          f"ms with the host out of the way: fused {a_ms:.4f}, errors only "
          f"{e_ms:.4f}, the parent's composition (errors, then "
          f"syndromes_of) {comp_ms:.4f}; back-to-back calls, host "
          f"included: fused {a_call:.4f}, composition {comp_call:.4f}; "
          f"plain {a_plain:.4f} ms; bound {a_bound[0]:.6f} ms "
          f"({a_bound[1]}); a lone call {1e6 * sorted(lone)[10]:.1f} us to "
          f"the end of the kernel, {1e6 * sorted(enqueue)[10]:.1f} us to "
          f"enqueue it, {1e6 * sorted(enqueue_e)[10]:.1f} us for the errors "
          f"alone (medians of 21); before the redesign, errors only: "
          f"{OLD['A 4096x544 ms']}  [{smi}]")
    tabsT = SyndromeTables.build(Tx, Tz, device=dev)
    aT_ms = device_ms(lambda: channel_cuda.sample_shot_tiles_cuda(
        keys, P_POINT, nT, 64, tabsT), 50)
    outT = channel_cuda.sample_shot_tiles_cuda(keys, P_POINT, nT, 64, tabsT)
    bT = bound(nbytes(keys, *outT, tabsT.z.rp, tabsT.z.cols, tabsT.x.rp,
                      tabsT.x.cols),
               outT[0].numel() * OPS_DRAW
               + OPS_EDGE * BATCH * (tabsT.z.cols.numel()
                                     + tabsT.x.cols.numel()))
    print(f"channel Tanner ({BATCH // 64} tiles x 64 x {nT}, both "
          f"syndromes): fused {aT_ms:.4f} ms on the device, bound "
          f"{bT[0]:.6f} ms ({bT[1]})  [{smi}]")

    def syndromes_at(p):
        ex, ez = channel_cuda.sample_tiles_cuda(keys, p, n, 64)
        return {"X": torch.remainder(ex.float() @ Hz_T, 2.0),
                "Z": torch.remainder(ez.float() @ Hx_T, 2.0)}

    def syn_of(H, p):
        """(m, B) syndromes of the port's channel's X errors through H."""
        ex = channel_cuda.sample_tiles_cuda(keys, p, H.shape[1], 64)[0]
        return torch.remainder(ex.float() @ torch.as_tensor(
            H.T, dtype=torch.float32, device=dev), 2.0).T.contiguous()

    L4z = np.asarray(get_code("lp04_0").Hz) % 2

    def qc_decoder(H, dec_type, max_iter, sched, chk="iter", stacked=False):
        return ms_qc_cuda.make_qc_decoder(
            detect_qc(H), DecoderConfig(dec_type=dec_type, max_iter=max_iter,
                                        schedule=sched, qc_check_every=chk),
            layers=build_layers(H, sched), device=dev, stacked=stacked)

    def compare_qc(label, dec, syn_T, lch, reps):
        """Kernel B against its plain version on one (m, B) syndrome set:
        prints both times and what differs; returns (kernel ms, plain ms,
        max |posterior diff|, exact?)."""
        kp, ki, kc = ms_qc_cuda.ms_qc_cuda(dec, syn_T, lch)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        pp, pi, pc = ms_qc_cuda.ms_qc_plain(dec, syn_T, lch)
        ev[1].record()
        ev[1].synchronize()
        p_ms = ev[0].elapsed_time(ev[1])    # the compared run itself, once
        err = float((kp - pp).abs().max())
        diff_shots = int(((kp < 0) != (pp < 0)).any(dim=0).sum())
        same = (torch.equal(ki, pi) and torch.equal(kc, pc)
                and torch.equal(kp, pp))
        k_ms = cuda_ms(lambda: ms_qc_cuda.ms_qc_cuda(dec, syn_T, lch), reps)
        ops = OPS_MS if dec.kind == "MS" else OPS_BP
        bnd = bound(nbytes(syn_T, kp, ki, kc),
                    dec.tabs.n_slots * dec.tabs.L * int(ki.sum()) * ops)
        print(f"{label} (B={syn_T.shape[1]}, {dec.max_iter} it, "
              f"{dec.threads} threads per shot, one per "
              f"{'edge' if dec.per_edge else 'check row'}): converged "
              f"{int(kc.sum())}, mean n_iter {float(ki.float().mean()):.4f}; "
              f"vs plain: n_iter differs on {int((ki != pi).sum())}, "
              f"converged on {int((kc != pc).sum())}, e_hat on {diff_shots} "
              f"shots, posterior elements differing "
              f"{int((kp != pp).sum())}, max|post diff| {err}; kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms (one run), bound "
              f"{bnd[0]:.6f} ms ({bnd[1]}, sum n_iter {int(ki.sum())})  "
              f"[{smi}]")
        return k_ms, p_ms, err, same, bnd

    def check_qc(label, dec, syn_T, lch_, plain=None):
        """Kernel B against its plain version (computed here unless given)
        on one more shape, untimed: n_iter, converged and every posterior
        element; returns the kernel's (n_iter, converged)."""
        kp, ki, kc = ms_qc_cuda.ms_qc_cuda(dec, syn_T, lch_)
        pp, pi, pc = plain or ms_qc_cuda.ms_qc_plain(dec, syn_T, lch_)
        torch.cuda.synchronize()
        same = (torch.equal(ki, pi) and torch.equal(kc, pc)
                and torch.equal(kp, pp))
        print(f"  {label} ({dec.kind}-{dec.max_iter}, B={syn_T.shape[1]}, "
              f"{len(dec.tabs.group_snap)} groups of which "
              f"{int(dec.tabs.group_snap.sum())} with a snapshot, degree <= "
              f"{dec.tabs.max_deg}, {dec.threads} threads per shot, one per "
              f"{'edge' if dec.per_edge else 'check row'}, state in "
              f"{'device' if dec.state_on_device else 'shared'} memory, "
              f"check per {'layer' if dec.track_mis else 'iteration'}): "
              f"converged {int(kc.sum())}, at the cap "
              f"{int((ki == dec.max_iter).sum())}; vs plain: n_iter differs "
              f"on {int((ki != pi).sum())}, converged on "
              f"{int((kc != pc).sum())}, posterior elements "
              f"{int((kp != pp).sum())}")
        check(same, f"kernel B {dec.kind} == plain: {label}")
        return ki, kc

    def grouped_layers(st, sizes):
        """Layers of whole block-rows, `sizes` block-rows each: groups whose
        block-rows share a variable block read a snapshot."""
        from qldpcsim_torch.decoders.common import LayerSchedule

        rows, i = [], 0
        for size in sizes:
            rows.append(np.arange(i * st.L, (i + size) * st.L))
            i += size
        return LayerSchedule.from_layers(rows, st.m)

    def more_qc_shapes(kind_, chk="iter"):
        """Kernel B on the shapes beside the main path's: other lifts, odd
        batches, zero syndromes, a high p, synthetic lifted codes, groups
        with a snapshot, both mappings and the device-memory state."""
        p_lo = np.float32(0.04) / np.float32(3.0)
        lch_ = ms_qc_cuda.llr_prior(p_lo)
        syn_x = syndromes_at(P_POINT)["X"].T.contiguous()
        for label, H, sched, syn_T, iters in (
                ("lp04_0 L", L4z, "L", syn_of(L4z, 0.04)[:, :300], 30),
                ("lp04_0 F", L4z, "F", syn_of(L4z, 0.04)[:, :300], 30),
                ("tanner L", Tz, "L", syn_of(Tz, 0.05)[:, :300], 20),
                (f"{CODE} L, a lone shot", Hz, "L", syn_x[:, 5:6], MAX_ITER),
                (f"{CODE} L, a last block not full", Hz, "L",
                 torch.cat([syn_x, syn_x[:, :3]], dim=1), GH_HEAD_ITER),
                (f"{CODE} L, p=0.2", Hz, "L",
                 syndromes_at(0.2)["X"].T[:, :300], 20),
                (f"{CODE} F", Hz, "F", syn_x[:, :300], 20)):
            if chk == "layer" and sched == "F":
                continue
            check_qc(label, qc_decoder(H, kind_, iters, sched, chk=chk),
                     syn_T.contiguous(), lch_)
        zi, zc = check_qc(f"{CODE} L, zero syndromes",
                          qc_decoder(Hz, kind_, MAX_ITER, "L", chk=chk),
                          torch.zeros_like(syn_x[:, :64]), lch_)
        check(bool((zi == 1).all() and zc.all()),
              "a zero syndrome takes one iteration")
        for name, sizes in (("irregular", None), ("deg12", None),
                            ("irregular", (2, 1, 3)), ("deg12", (2, 1)),
                            ("irregular", "F"), ("deg12", "F")):
            if chk == "layer" and sizes == "F":
                continue
            st = synthetic_lift(name)
            dec = ms_qc_cuda.make_qc_decoder(
                st, DecoderConfig(
                    dec_type=kind_, max_iter=20, qc_check_every=chk,
                    schedule="F" if sizes == "F" else "L"),
                layers=(grouped_layers(st, sizes)
                        if isinstance(sizes, tuple) else None), device=dev)
            if isinstance(sizes, tuple):
                check(bool(dec.tabs.group_snap.any()),
                      "the grouped layers need a snapshot")
            check_qc(f"synthetic {name}, layers {sizes}", dec,
                     syn_of(st.lift(), 0.04)[:, :200].contiguous(), lch_)
        # both mappings, and the state in device memory, forced on small
        # codes (the tables of no library code ask for the latter)
        for label, H, sched in ((f"{CODE} L", Hz, "L"), ("tanner L", Tz, "L"),
                                (f"{CODE} F", Hz, "F")):
            if chk == "layer" and sched == "F":
                continue
            dec = qc_decoder(H, kind_, 20, sched, chk=chk)
            syn_T = syn_of(H, 0.05)[:, :150].contiguous()
            plain = ms_qc_cuda.ms_qc_plain(dec, syn_T, lch_)
            check(not dec.state_on_device, "a library code fits shared memory")
            chosen = dec.per_edge
            for on_device in (False, True):
                dec.state_on_device = on_device
                for per_edge in (chosen, not chosen):
                    dec.per_edge = per_edge
                    check_qc(label, dec, syn_T, lch_, plain)

    def mapping_name(per_edge, threads):
        return f"{'edge' if per_edge else 'row'}/{threads}"

    def both_mappings(dec, fn):
        """fn() under the mapping the decoder's tables chose and under the
        other one: {mapping name: value}, the chosen one first."""
        chosen, out = dec.per_edge, {}
        for per_edge in (chosen, not chosen):
            dec.per_edge = per_edge
            out[mapping_name(per_edge, dec.threads)] = fn()
        dec.per_edge = chosen
        return out

    def time_mappings(label, dec, syn_T, lch_, reps=20):
        """Kernel B's time on one shape under the decoder's mapping (a
        thread per check row or per edge / threads per shot) and under the
        other one."""
        ms = both_mappings(dec, lambda: cuda_ms(
            lambda: ms_qc_cuda.ms_qc_cuda(dec, syn_T, lch_), reps))
        print(f"  {label} (B={syn_T.shape[1]}, {dec.max_iter} it), ms, the "
              f"decoder's mapping first: "
              + ", ".join(f"{k}: {v:.4f}" for k, v in ms.items())
              + f"  [{smi}]")

    def lone_shot(label, dec, syn_T, lch_, old_us):
        """A shot that runs every iteration, alone: microseconds per
        iteration under both mappings (launch included)."""
        ki = ms_qc_cuda.ms_qc_cuda(dec, syn_T, lch_)[1]
        slow = torch.nonzero(ki == dec.max_iter).flatten()
        check(slow.numel() > 0, "a shot ran every iteration")
        one = syn_T[:, slow[:1]].contiguous()
        us = both_mappings(dec, lambda: 1e3 * cuda_ms(
            lambda: ms_qc_cuda.ms_qc_cuda(dec, one, lch_), 20) / dec.max_iter)
        print(f"  {label}, a lone shot of {dec.max_iter} iterations, us per "
              f"iteration, the decoder's mapping first: "
              + ", ".join(f"{k}: {v:.3f}" for k, v in us.items())
              + f" (one thread per shot, before the redesign: {old_us})  "
              f"[{smi}]")

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
    print(f"kernel B MS {SCHEDULE} side X, B={BATCH}, {MAX_ITER} it: "
          f"{b_times[(SCHEDULE, 'X')][0]:.4f} ms (one thread per shot, before "
          f"the redesign: {OLD['B MS L 4096x50 ms']} ms)")
    more_qc_shapes("MS")
    # a thread per edge or per check row: the flagship's two shapes (the
    # cascade's head on the full batch, its last stage on a window), and a
    # lone shot
    syn_x = syn["X"].T.contiguous()
    head = qc_decoder(Hz, "MS", GH_HEAD_ITER, SCHEDULE)
    deep = qc_decoder(Hz, "MS", MAX_ITER, SCHEDULE)
    left = torch.nonzero(~ms_qc_cuda.ms_qc_cuda(head, syn_x, lch)[2]).flatten()
    check(left.numel() >= GH_TAIL_SHOTS, "the head left a tail window")
    tail_x = syn_x[:, left[:GH_TAIL_SHOTS]].contiguous()
    time_mappings(f"MS-{SCHEDULE} cascade head", head, syn_x, lch)
    time_mappings(f"MS-{SCHEDULE} second stage",
                  qc_decoder(Hz, "MS", 10, SCHEDULE),
                  syn_x[:, left[:512]].contiguous(), lch)
    time_mappings(f"MS-{SCHEDULE} tail window", deep, tail_x, lch)
    time_mappings(f"MS-{SCHEDULE} full depth", deep, syn_x, lch)
    time_mappings("MS-F full depth", qc_decoder(Hz, "MS", MAX_ITER, "F"),
                  syn_x, lch)
    lone_shot(f"MS-{SCHEDULE}", deep, syn_x, lch, OLD["B MS lone us/it"])
    lone_shot("MS-F", qc_decoder(Hz, "MS", MAX_ITER, "F"), syn_x, lch,
              OLD["B MS lone us/it"])

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
    print(f"kernel B BP {C5_SCHEDULE} side X, B={BATCH}, {C5_ITER} it: "
          f"{bp_times['X'][0]:.4f} ms (one thread per shot, before the "
          f"redesign: {OLD['B BP F 4096x99 ms']} ms)")
    more_qc_shapes("BP")
    syn_x5 = syn["X"].T.contiguous()
    deep5 = qc_decoder(Hz, "BP", C5_ITER, C5_SCHEDULE)
    time_mappings(f"BP-{C5_SCHEDULE} full depth", deep5, syn_x5, lch5, 10)
    time_mappings(f"BP-{C5_SCHEDULE} cascade head",
                  qc_decoder(Hz, "BP", GH_HEAD_ITER, C5_SCHEDULE), syn_x5,
                  lch5)
    time_mappings(f"BP-{SCHEDULE} full depth",
                  qc_decoder(Hz, "BP", MAX_ITER, SCHEDULE), syn_x5, lch5, 10)
    lone_shot(f"BP-{C5_SCHEDULE}", deep5, syn_x5, lch5,
              OLD["B BP lone us/it"])
    lone_shot(f"BP-{SCHEDULE}", qc_decoder(Hz, "BP", MAX_ITER, SCHEDULE),
              syn_x, lch, OLD["B BP lone us/it"])

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
    kt, kp, ks = gf2_elim_cuda.eliminate_cuda(colsP, osd.r, osd.rW,
                                              osd.elim_plan)
    pt, pp, ps = gf2_elim_cuda.eliminate_plain(colsP, osd.r, osd.rW)
    torch.cuda.synchronize()
    c_same = (torch.equal(kt, pt) and torch.equal(kp, pp)
              and torch.equal(ks, ps))
    c_err = int((kt != pt).sum() + (kp != pp).sum() + (ks != ps).sum())
    c_plain = cuda_ms(
        lambda: gf2_elim_cuda.eliminate_plain(colsP, osd.r, osd.rW), 2)
    # each shot's sweep reads its columns up to the last one it selects and
    # folds every selected column into the basis: at least one pass over a
    # column's check and tag words for each
    last = (ks * torch.arange(1, n + 1, device=dev)).max(dim=1).values
    examined = int(last.sum())
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
          f"differing from plain {c_err}; plain {c_plain:.4f} ms  [{smi}]")
    # both mappings of the back-elimination, the window and a lone shot
    one = colsP[:1].contiguous()
    one_cols = int(last[0])
    one_bound = bound(nbytes(one, kt[:1], kp[:1], ks[:1]),
                      (one_cols + int(ks[0].sum())) * (osd.mW + osd.rW))
    c_times = {}
    for pairs in (False, True):
        pl = gf2_elim_cuda.plan(osd.r, osd.mW, osd.rW, pairs=pairs)
        out = gf2_elim_cuda.eliminate_cuda(colsP, osd.r, osd.rW, pl)
        same = (torch.equal(out[0], pt) and torch.equal(out[1], pp)
                and torch.equal(out[2], ps))
        check(same, f"kernel C ({'pairs' if pairs else 'rows'}) == plain")
        w_ms = cuda_ms(
            lambda: gf2_elim_cuda.eliminate_cuda(colsP, osd.r, osd.rW, pl),
            20)
        o_ms = cuda_ms(
            lambda: gf2_elim_cuda.eliminate_cuda(one, osd.r, osd.rW, pl), 20)
        c_times[pairs] = (w_ms, o_ms)
        chosen = "; the plan OSD chose" if pl == osd.elim_plan else ""
        mapping = ("a thread per (row, word) pair" if pairs
                   else "a thread per basis row")
        print(f"gf2_elim, {mapping} ({pl.threads} threads, {pl.lanes} per "
              f"row, stride {pl.stride}{chosen}): window {w_ms:.4f} ms = "
              f"{1e3 * w_ms * ELIM_WINDOW / examined:.3f} "
              f"us per column of a shot (before the redesign: "
              f"{OLD['C 256-window ms']} ms); a lone shot {o_ms:.4f} ms for "
              f"{one_cols} columns = {1e3 * o_ms / one_cols:.3f} us per "
              f"column (bound {1e3 * one_bound[0] / one_cols:.6f} us per "
              f"column, {one_bound[1]})  [{smi}]")
    c_ms = c_times[osd.elim_plan.lanes > 1][0]
    # a basis beyond a block's shared memory: 1200 checks, 77-word rows
    rng = np.random.default_rng(12)
    Hbig = np.zeros((1200, 2400), np.int8)
    for j in range(2400):
        Hbig[rng.choice(1200, 3, replace=False), j] = 1
    big = OSD(Hbig, C5_ORDER, device=dev)
    check(big.elim_plan.state_on_device, "the 1200-check basis lies in "
          "device memory")
    big_cols = big.cols[torch.stack([
        torch.from_numpy(rng.permutation(Hbig.shape[1]))
        for _ in range(ELIM_WINDOW)]).to(dev)].contiguous()
    bt, bp_, bs = gf2_elim_cuda.eliminate_plain(big_cols, big.r, big.rW)
    for pairs in (False, True):
        pl = gf2_elim_cuda.plan(big.r, big.mW, big.rW, pairs=pairs)
        out = gf2_elim_cuda.eliminate_cuda(big_cols, big.r, big.rW, pl)
        same = (torch.equal(out[0], bt) and torch.equal(out[1], bp_)
                and torch.equal(out[2], bs))
        check(same, "kernel C == plain on the 1200-check basis")
        b_ms = cuda_ms(lambda: gf2_elim_cuda.eliminate_cuda(
            big_cols, big.r, big.rW, pl), 3)
        chosen = "; the plan OSD chose" if pl == big.elim_plan else ""
        print(f"gf2_elim 1200 x 2400 (r {big.r}, {big.mW} + {big.rW} words "
              f"a row), {ELIM_WINDOW} shots, basis in device memory "
              f"({big.r * pl.stride * 4} bytes a shot), "
              f"{'pairs' if pairs else 'rows'} ({pl.threads} threads)"
              f"{chosen}: equal to plain, "
              f"{b_ms:.4f} ms (before the redesign the launch was "
              f"refused)  [{smi}]")
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
    check_fused(launches, "flagship")
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
    check(round(res.qbler, 8) == 0.04516602,
          "the flagship's qBLER at seed 0 is 0.04516602 (2,960 of 65,536 "
          "shots), as in every earlier run")

    def timed_run(label, Hx_, Hz_, p_, cfg_, pipe_, shots_, old, p_index=0):
        """The same path once more with enough shots for a warm window of
        a second or so: warm shots/s beside the rate before the redesign."""
        r = simulate_p(Hx_, Hz_, p_, dataclasses.replace(cfg_, shots=shots_),
                       pipeline=pipe_, p_index=p_index)
        print(f"  timed run, {label}: {shots_} shots, warm {r.warm_shots} "
              f"shots in {r.warm_time_s:.3f} s = {r.shots_per_s_warm:.1f} "
              f"shots/s (before the redesign of its decode kernel: {old}); "
              f"qBLER {r.qbler!r}  [{smi}]")
        check(r.shots == shots_ and 0.0 <= r.qbler <= 1.0,
              f"timed run {label}")
        return r

    timed7 = timed_run("flagship", Hx, Hz, P_POINT, cfg, pipe, TIMED_SHOTS,
                       OLD["flagship shots/s"])
    breakdown(pipe, P_POINT, ("channel", "decode X", "decode Z", "classify"),
              smi)
    print(f"  lanes per cascade stage {pipe.dec_x.stages}: X "
          f"{pipe.dec_x.stage_lanes}, Z {pipe.dec_z.stage_lanes}")

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
    check_fused(launches5, "config 5")
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
    timed_run("config 5 on kernel B", Hx, Hz, C5_P, cfg5, pipe5, TIMED_SHOTS,
              OLD["config 5 shots/s"])
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

    def compare_seq(label, dec, syn_T, reps, plain=seq_qc_cuda.seq_qc_plain):
        """Kernel D against a plain version (row by row, or the block-row
        formulation) on one (m, B) syndrome set; returns (kernel ms, plain
        ms, max |posterior diff|, equal?, bound). The posterior is compared
        by value (a warp that has left keeps a stored -0.0 where the plain
        version's masked update stores +0.0)."""
        kp, ki, kc = seq_qc_cuda.seq_qc_cuda(dec, syn_T, lch_seq)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pp, pi, pc = plain(dec, syn_T, lch_seq)
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
              f"{k_ms:.4f} ms, plain ({plain.__name__}) {p_ms:.3f} ms (one "
              f"run, host clock), bound {bnd[0]:.6f} ms ({bnd[1]}, sum n_iter "
              f"{int(ki.sum())}, {nbytes(syn_T, kp, ki, kc)} bytes)  [{smi}]")
        return k_ms, p_ms, err, same, bnd

    def check_seq(label, dec, syn_T, lch_):
        """Kernel D against the row-by-row plain version and the block-row
        formulation on one more shape, untimed; returns the kernel's
        (n_iter, converged)."""
        kp, ki, kc = seq_qc_cuda.seq_qc_cuda(dec, syn_T, lch_)
        pp, pi, pc = seq_qc_cuda.seq_qc_plain(dec, syn_T, lch_)
        bp_, bi, bc = seq_qc_cuda.seq_qc_plain_blockrow(dec, syn_T, lch_)
        torch.cuda.synchronize()
        same = (torch.equal(ki, pi) and torch.equal(kc, pc)
                and torch.equal(kp, pp))
        twin = (torch.equal(bi, pi) and torch.equal(bc, pc)
                and torch.equal(bp_, pp))
        print(f"  {label} ({dec.kind}-S-{dec.max_iter}, B={syn_T.shape[1]}, "
              f"lift {dec.tabs.L}, degree <= {dec.tabs.max_deg}, state in "
              f"{'device' if dec.state_on_device else 'shared'} memory): "
              f"converged {int(kc.sum())}, at the cap "
              f"{int((ki == dec.max_iter).sum())}; vs plain: n_iter differs "
              f"on {int((ki != pi).sum())}, converged on "
              f"{int((kc != pc).sum())}, posterior elements by value "
              f"{int((kp != pp).sum())}; the block-row formulation equals "
              f"the row-by-row one: {twin}")
        check(same, f"kernel D {dec.kind} == plain: {label}")
        check(twin, f"block-row formulation == row by row: {label}")
        return ki, kc

    def more_seq_shapes(kind_):
        """Kernel D on the shapes beside the main path's."""
        lch_ = ms_qc_cuda.llr_prior(np.float32(0.04) / np.float32(3.0))
        for label, H, syn_T, iters in (
                ("lp04_0", L4z, syn_of(L4z, 0.04)[:, :300], 8),
                (f"{CODE}", Hz, syn_of(Hz, 0.04)[:, :300], 3),
                ("tanner, a lone shot", Tz, synT["X"][:, 7:8], 3),
                ("tanner, a last block not full", Tz,
                 torch.cat([synT["X"][:, :1021], synT["X"][:, :2]], dim=1), 2),
                ("lp04_0, p=0.2", L4z, syn_of(L4z, 0.2)[:, :300], 6)):
            check_seq(label, seq_decoder(H, kind_, iters), syn_T.contiguous(),
                      lch_)
        zi, zc = check_seq("tanner, zero syndromes",
                           seq_decoder(Tz, kind_, 4),
                           torch.zeros_like(synT["X"][:, :64]), lch_)
        check(bool((zi == 1).all() and zc.all()),
              "a zero syndrome latches after row 0")
        for name in ("irregular", "deg12"):
            st = synthetic_lift(name)
            dec = seq_qc_cuda.make_seq_qc_decoder(
                st, DecoderConfig(dec_type=kind_, max_iter=8, schedule="S"),
                device=dev, kind=kind_)
            check_seq(f"synthetic {name}", dec,
                      syn_of(st.lift(), 0.04)[:, :200].contiguous(), lch_)
        # the state in device memory, forced on small codes
        for label, H, iters in (("tanner", Tz, 2), ("lp04_0", L4z, 8)):
            dec = seq_decoder(H, kind_, iters)
            check(not dec.state_on_device, "a library code fits shared memory")
            dec.state_on_device = True
            check_seq(label, dec, syn_of(H, 0.05)[:, :150].contiguous(), lch_)

    d_times, worst_d = {}, {}
    for number, kind_ in ((11, "MS"), (12, "BP")):
        phase(f"{number} kernel D, kind {kind_}")
        print(f"depth chosen: B={BATCH} at {SEQ_HEAD_ITER} iterations on both "
              f"sides, B={SEQ_TAIL_SHOTS} at {C4_ITER} iterations on side X; "
              f"kernel alone at B={BATCH} and {C4_ITER} iterations")
        worst_d[kind_] = 0.0
        # side X against the row-by-row plain version, the oracle; side Z
        # and the tail window against the block-row formulation
        for side, H, plain in (("X", Tz, seq_qc_cuda.seq_qc_plain),
                               ("Z", Tx, seq_qc_cuda.seq_qc_plain_blockrow)):
            out = compare_seq(f"seq_qc {kind_} side {side} p={SEQ_P}",
                              seq_decoder(H, kind_, SEQ_HEAD_ITER),
                              synT[side], 20, plain)
            worst_d[kind_] = max(worst_d[kind_], out[2])
            d_times[(kind_, side)] = out
            check(out[3], f"kernel D {kind_} == plain (side {side}, head)")
        print(f"kernel D {kind_} side X, B={BATCH}, {SEQ_HEAD_ITER} it: "
              f"{d_times[(kind_, 'X')][0]:.4f} ms (one thread per shot, "
              f"before the redesign: {OLD[f'D {kind_} 4096x4 ms']} ms)")
        # the tail window: shots the head left unconverged, at full depth
        kc = seq_qc_cuda.seq_qc_cuda(seq_decoder(Tz, kind_, SEQ_HEAD_ITER),
                                     synT["X"], lch_seq)[2]
        tail = torch.nonzero(~kc).flatten()[:SEQ_TAIL_SHOTS]
        check(tail.numel() == SEQ_TAIL_SHOTS, "the head left a tail window")
        out = compare_seq(f"seq_qc {kind_} side X tail window",
                          seq_decoder(Tz, kind_, C4_ITER),
                          synT["X"][:, tail].contiguous(), 20,
                          seq_qc_cuda.seq_qc_plain_blockrow)
        worst_d[kind_] = max(worst_d[kind_], out[2])
        check(out[3], f"kernel D {kind_} == plain (side X, tail window)")
        deep = seq_decoder(Tz, kind_, C4_ITER)
        full_ms = cuda_ms(lambda: seq_qc_cuda.seq_qc_cuda(
            deep, synT["X"], lch_seq), 10)
        ki = seq_qc_cuda.seq_qc_cuda(deep, synT["X"], lch_seq)[1]
        slow = torch.nonzero(ki == C4_ITER).flatten()
        check(slow.numel() > 0, "a shot ran every iteration")
        one = synT["X"][:, slow[:1]].contiguous()
        lone_ms = cuda_ms(lambda: seq_qc_cuda.seq_qc_cuda(
            deep, one, lch_seq), 20)
        full_bnd = bound(nbytes(synT["X"], ki) + 4 * nT * BATCH + BATCH,
                         deep.tabs.n_slots * deep.tabs.L * int(ki.sum())
                         * (OPS_MS if kind_ == "MS" else OPS_BP))
        print(f"seq_qc {kind_} side X, kernel alone: B={BATCH} at {C4_ITER} "
              f"it {full_ms:.4f} ms (mean n_iter "
              f"{float(ki.float().mean()):.4f}, at the cap "
              f"{int((ki == C4_ITER).sum())}; bound {full_bnd[0]:.6f} ms, "
              f"{full_bnd[1]}; one thread per shot, before the redesign: "
              f"{OLD['D MS 4096x30 ms'] if kind_ == 'MS' else 'not measured'}"
              f" ms); a lone shot {lone_ms:.4f} ms for {C4_ITER} iterations = "
              f"{1e3 * lone_ms / C4_ITER:.3f} us per iteration (launch "
              f"included; before: {OLD[f'D {kind_} lone us/it']})  [{smi}]")
        more_seq_shapes(kind_)

    # 13. config 4 through the p-sweep entry point, uncut
    phase("13 config 4 (Tanner, MS-S-30, p-sweep)")
    files4 = [os.path.join(HERE, f) for f in C4_FILES]
    # one sweep for the results table and the launch counts of the path
    reset_launches()
    res4 = simulate(files4[0], files4[1], C4_P, shots=C4_SHOTS,
                    decType="MS", decIterations=C4_ITER, decSchedule="S",
                    rngSeed=SEED)
    launches4 = read_launches()
    check_fused(launches4, "config 4")
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
    # per p once more on one pipeline, for launches and syncs per p
    cfg4 = SimConfig(shots=C4_SHOTS, dec_type="MS", dec_iterations=C4_ITER,
                     dec_schedule="S", rng_seed=SEED, device="cuda")
    pipe4 = ShotPipeline(Tx, Tz, cfg4)
    check(pipe4.batch == BATCH, f"config-4 chunk {pipe4.batch}")
    prev_q = -1.0
    for i, pT in enumerate(C4_P):
        for d in (pipe4.dec_x, pipe4.dec_z):
            d.full_calls = d.syncs = 0
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
        print(f"    full-depth launches X {pipe4.dec_x.full_calls} Z "
              f"{pipe4.dec_z.full_calls}, cascade host syncs X "
              f"{pipe4.dec_x.syncs} Z {pipe4.dec_z.syncs}, over "
              f"{C4_SHOTS // BATCH} chunks")
        check(pipe4.dec_x.syncs == pipe4.dec_z.syncs == 0,
              f"p={pT}: kernel D's cascade makes no host sync")
        c = r.counters
        check(c["decSuccessExact"] + c["DecFailures_X"] <= C4_SHOTS
              and c["successStabilizer"] >= c["decSuccessExact"],
              "config-4 counters consistent")
        check(prev_q <= r.qbler <= 1.0, f"qBLER {r.qbler} grows with p")
        prev_q = r.qbler
        for it in (r.avg_iterations_x, r.avg_iterations_z):
            check(1.0 <= it <= C4_ITER, f"average iterations {it}")
        timed_run(f"config 4, p={pT}", Tx, Tz, pT, cfg4, pipe4,
                  C4_TIMED_SHOTS[i], OLD["config 4 shots/s"][i], p_index=i)
        if pT in (C4_P[0], C4_P[-1]):
            breakdown(pipe4, pT, ("channel", "decode X", "decode Z",
                                  "classify"), smi,
                      chunks=C4_BREAKDOWN_CHUNKS, p_index=i)
    check(pipe4.dec_x.full_calls > 0 and pipe4.dec_z.full_calls > 0,
          f"kernel D's cascade took the full-depth launch at p={C4_P[-1]}")
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
            cfg4, shots=C4_CROSS_SHOTS, batch_size=C4_CROSS_SHOTS,
            device=device), p_index=1)
        small4[device] = dict(r.counters,
                              nIterAccX=r.avg_iterations_x * r.shots,
                              nIterAccZ=r.avg_iterations_z * r.shots)
        print(f"config 4 cross-device p={C4_P[1]}, first {C4_CROSS_SHOTS} "
              f"shots: {device} {small4[device]} "
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

    def gh_variants(dec):
        """Kernel E's variants on one decoder, the tables' choice first:
        both mappings (a thread per edge only for rows of at most 32 slots),
        each with the state in shared memory (where it fits) and in device
        memory. [(name, per_edge, state_on_device), ...]"""
        chosen = (dec.per_edge, dec.state_on_device)
        maps = ((chosen[0], not chosen[0]) if dec.tabs.dmax <= 32
                else (False,))
        places = (chosen[1], not chosen[1]) if not chosen[1] else (True,)
        return [(f"{mapping_name(pe, dec.threads)} "
                 f"{'device' if od else 'shared'}", pe, od)
                for od in places for pe in maps]

    def gh_all_variants(label, dec, syn_T, reps, plain=None, lone=False):
        """Kernel E under every variant of `gh_variants` against its plain
        version (n_iter, converged, posterior by value), each timed: ms per
        launch, or with `lone` microseconds per iteration of a one-shot
        launch. Returns {variant: time}, the tables' choice first."""
        pp, pi, pc = plain or general_h_cuda.general_h_plain(dec, syn_T, lch)
        chosen = (dec.per_edge, dec.state_on_device)
        out = {}
        for name, per_edge, on_device in gh_variants(dec):
            dec.per_edge, dec.state_on_device = per_edge, on_device
            kp, ki, kc = general_h_cuda.general_h_cuda(dec, syn_T, lch)
            torch.cuda.synchronize()
            same = (torch.equal(ki, pi) and torch.equal(kc, pc)
                    and torch.equal(kp, pp))
            check(same, f"kernel E {dec.kind} == plain: {label}, {name}")
            ms = cuda_ms(lambda: general_h_cuda.general_h_cuda(
                dec, syn_T, lch), reps)
            out[name] = 1e3 * ms / int(ki[0]) if lone else ms
        dec.per_edge, dec.state_on_device = chosen
        unit = "us per iteration" if lone else "ms"
        print(f"  {label} (B={syn_T.shape[1]}, {dec.max_iter} it, "
              f"{dec.smem_bytes} B of shared memory per block, tables in "
              f"{'shared' if dec.tables_in_shared else 'device'} memory), "
              f"{unit}, equal to plain under every variant, the tables' "
              f"choice first: "
              + ", ".join(f"{k}: {v:.4f}" for k, v in out.items())
              + f"  [{smi}]")
        return out

    syn_perm = syn_of(Pz, P_POINT)
    syn_bic = syn_of(Bz, GH_BICYCLE_P)
    syn_irr = syn_of(Irr, 0.017)
    e_times, worst_e = {}, {}
    for number, kind_ in ((15, "MS"), (16, "BP")):
        phase(f"{number} kernel E, kind {kind_}")
        print(f"depth chosen: the cascade's stages on the permuted {CODE} "
              f"(B={BATCH} at {GH_HEAD_ITER} iterations, the head's "
              f"unconverged shots up to 512 at 10, "
              f"{GH_TAIL_SHOTS} at {MAX_ITER}), the kernel alone at "
              f"B={BATCH} and {MAX_ITER} iterations, a lone shot")
        worst_e[kind_] = 0.0
        for sched in (SCHEDULE, "F"):
            head = gh_decoder(Pz, kind_, GH_HEAD_ITER, sched)
            out = compare_gh(f"general_h {kind_} {sched} permuted {CODE} "
                             f"side X p={P_POINT}", Pz, head, syn_perm, 5)
            worst_e[kind_] = max(worst_e[kind_], out[2])
            e_times[(kind_, sched)] = out
            check(out[3], f"kernel E {kind_} == plain ({sched}, head)")
            print(f"  tables' choice: {mapping_name(head.per_edge, head.threads)}"
                  f", state in {'device' if head.state_on_device else 'shared'}"
                  f" memory (before the redesign: "
                  f"{OLD[f'E {kind_} {sched} 4096x4 ms']})")
            gh_all_variants(f"general_h {kind_} {sched} cascade head", head,
                            syn_perm, 5)
            # the later stages: shots the head left unconverged
            kc = general_h_cuda.general_h_cuda(head, syn_perm, lch)[2]
            left = torch.nonzero(~kc).flatten()
            check(left.numel() >= GH_TAIL_SHOTS, "the head left a tail window")
            tail = left[:GH_TAIL_SHOTS]
            deep = gh_decoder(Pz, kind_, MAX_ITER, sched)
            if sched == SCHEDULE:
                gh_all_variants(f"general_h {kind_} {sched} second stage",
                                gh_decoder(Pz, kind_, 10, sched),
                                syn_perm[:, left[:512]].contiguous(), 5)
            gh_all_variants(f"general_h {kind_} {sched} last stage", deep,
                            syn_perm[:, tail].contiguous(), 5)
            full = gh_all_variants(f"general_h {kind_} {sched} full depth",
                                   deep, syn_perm, 2)
            print(f"  full depth before the redesign: "
                  f"{OLD[f'E {kind_} {sched} 4096x50 ms']}; now "
                  f"{next(iter(full.values())):.4f} ms")
            ki = general_h_cuda.general_h_cuda(deep, syn_perm, lch)[1]
            slow = torch.nonzero(ki == MAX_ITER).flatten()
            check(slow.numel() > 0, "a shot ran every iteration")
            gh_all_variants(f"general_h {kind_} {sched} a lone shot of "
                            f"{MAX_ITER} iterations (before the redesign, a "
                            f"lone thread: {OLD[f'E {kind_} lone us/it']} "
                            f"us per iteration)",
                            deep, syn_perm[:, slow[:1]].contiguous(), 10,
                            lone=True)
            # syndromes in, posterior, n_iter and converged out; every edge
            # of every iteration
            e_lone = bound(4 * (Pz.shape[0] + Pz.shape[1]) + 5,
                           deep.tabs.n_edges * MAX_ITER
                           * (OPS_MS if kind_ == "MS" else OPS_BP))
            print(f"  bound of that lone shot: "
                  f"{1e3 * e_lone[0] / MAX_ITER:.6f} us per iteration "
                  f"({e_lone[1]})  [{smi}]")
        for label, H, syn_T in (("bicycle", Bz, syn_bic),
                                ("irregular 240x544", Irr, syn_irr)):
            dec = gh_decoder(H, kind_, GH_HEAD_ITER, SCHEDULE)
            out = compare_gh(f"general_h {kind_} {SCHEDULE} {label}", H,
                             dec, syn_T, 5)
            worst_e[kind_] = max(worst_e[kind_], out[2])
            check(out[3], f"kernel E {kind_} == plain ({label})")
            gh_all_variants(f"general_h {kind_} {SCHEDULE} {label}", dec,
                            syn_T, 5)
        # zero syndromes and p = 0.2 on the permuted code, both schedules
        zdec = gh_decoder(Pz, kind_, MAX_ITER, SCHEDULE)
        zero = torch.zeros_like(syn_perm[:, :64])
        gh_all_variants(f"general_h {kind_} {SCHEDULE} zero syndromes", zdec,
                        zero, 2)
        zi = general_h_cuda.general_h_cuda(zdec, zero, lch)[1]
        check(bool((zi == 1).all()), "a zero syndrome takes one iteration")
        syn_hi = syn_of(Pz, 0.2)[:, :300].contiguous()
        for sched in (SCHEDULE, "F"):
            gh_all_variants(f"general_h {kind_} {sched} p=0.2",
                            gh_decoder(Pz, kind_, 20, sched), syn_hi, 2)

    # 17. the non-QC main path
    phase("17 non-QC main path (permuted lp118_0, MS-L-50, p=0.05)")
    cfgE = SimConfig(shots=SHOTS, dec_type="MS", dec_iterations=MAX_ITER,
                     dec_schedule=SCHEDULE, batch_size=BATCH, rng_seed=SEED,
                     device="cuda")
    pipeE = ShotPipeline(Px, Pz, cfgE)
    reset_launches()
    resE = simulate_p(Px, Pz, P_POINT, cfgE, pipeline=pipeE)
    launchesE = read_launches()
    check_fused(launchesE, "non-QC")
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
    timed_run("non-QC main path", Px, Pz, P_POINT, cfgE, pipeE, TIMED_SHOTS,
              OLD["non-QC shots/s"])
    breakdown(pipeE, P_POINT, ("channel", "decode X", "decode Z", "classify"),
              smi, stages=True)
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
            check_fused(la, f"{label} p={pT}")
            if r.wall_time_s < 1.0:
                # once more, now warm from the first chunk on
                t0 = time.perf_counter()
                r2 = simulate_p(cs.Hx, cs.Hz, pT, cfgS,
                                pipeline=pipes["cuda"], p_index=i)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                check(r2.counters == r.counters,
                      f"{label}: a rerun's counters")
                rate = (f"second run {shots_} shots in {secs:.4f} s = "
                        f"{shots_ / secs:.1f} shots/s")
            else:
                # long enough as it is: its own chunks after the first
                rate = (f"warm {r.warm_shots} shots in {r.warm_time_s:.4f} "
                        f"s = {r.shots_per_s_warm:.1f} shots/s")
            print(f"  p={pT}: counters {json.dumps(r.counters)}")
            print(f"    qBLER {r.qbler!r}  avg iterations X "
                  f"{r.avg_iterations_x!r} Z {r.avg_iterations_z!r}; "
                  f"{rate}; launches "
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

    # 21. kernel F against its plain version, with kernel B beside it
    syn5 = syndromes_at(C5_P)["X"].contiguous()            # (B, m)
    syn_l4 = syn_of(L4z, 0.04).T.contiguous()
    syn_tan = synT["X"].T.contiguous()

    def compare_flood(label, dec, syn_, lch_, reps):
        """Kernel F against its plain version on one (B, m) syndrome set;
        returns (kernel ms, plain ms, max |posterior diff|, equal?, bound).
        The posterior is compared by value."""
        kp, ki, kc = flood_qc_cuda.flood_qc_cuda(dec, syn_, lch_)
        pp, pi, pc = flood_qc_cuda.flood_qc_plain(dec, syn_, lch_)
        torch.cuda.synchronize()
        err = float((kp - pp).abs().max())
        diff_shots = int(((kp < 0) != (pp < 0)).any(dim=1).sum())
        same = (torch.equal(ki, pi) and torch.equal(kc, pc)
                and diff_shots == 0 and torch.equal(kp, pp))
        k_ms = cuda_ms(lambda: flood_qc_cuda.flood_qc_cuda(dec, syn_, lch_),
                       reps)
        p_ms = cuda_ms(lambda: flood_qc_cuda.flood_qc_plain(dec, syn_, lch_),
                       1)
        ops = OPS_MS if dec.kind == "MS" else OPS_BP
        bnd = bound(nbytes(syn_, kp, ki, kc),
                    dec.tabs.n_slots * dec.tabs.L * int(ki.sum()) * ops)
        print(f"{label} (B={syn_.shape[0]}, {dec.max_iter} it, degree "
              f"{dec.tabs.n_slots // dec.tabs.m_b}): converged "
              f"{int(kc.sum())}, mean n_iter {float(ki.float().mean()):.4f}; "
              f"vs plain: n_iter differs on {int((ki != pi).sum())}, "
              f"converged on {int((kc != pc).sum())}, e_hat on {diff_shots} "
              f"shots, posterior elements differing by value "
              f"{int((kp != pp).sum())}, max|post diff| {err}; kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {bnd[0]:.6f} ms "
              f"({bnd[1]}, sum n_iter {int(ki.sum())}, "
              f"{nbytes(syn_, kp, ki, kc)} bytes)  [{smi}]")
        return k_ms, p_ms, err, same, bnd

    def beside_b(label, H, kind_, max_iter, syn_, lch_):
        """Kernels F and B on the same syndromes: times, and the shots whose
        results differ between the two."""
        df = qc_decoder(H, kind_, max_iter, "F", stacked=True)
        db = qc_decoder(H, kind_, max_iter, "F")
        check(df.stacked and not db.stacked, "the keyword selects the kernel")
        syn_T_ = syn_.T.contiguous()
        fp, fi, fc = flood_qc_cuda.flood_qc_cuda(df, syn_, lch_)
        bp_, bi, bc = ms_qc_cuda.ms_qc_cuda(db, syn_T_, lch_)
        f_ms = cuda_ms(lambda: flood_qc_cuda.flood_qc_cuda(df, syn_, lch_), 5)
        b_ms_ = cuda_ms(lambda: ms_qc_cuda.ms_qc_cuda(db, syn_T_, lch_), 2)
        e_diff = int(((fp < 0) != (bp_.T < 0)).any(dim=1).sum())
        print(f"{label}: kernel F {f_ms:.4f} ms, kernel B {b_ms_:.3f} ms "
              f"({b_ms_ / f_ms:.1f}x); between the two kernels e_hat differs "
              f"on {e_diff} shots, n_iter on {int((fi != bi).sum())}, "
              f"converged on {int((fc != bc).sum())}, max|post diff| "
              f"{float((fp - bp_.T).abs().max())}  [{smi}]")
        return e_diff, int((fi != bi).sum()), int((fc != bc).sum())

    f_times, worst_f = {}, {}
    phase("21 kernel F (slot-stacked flooding), kinds MS and BP")
    for kind_ in ("MS", "BP"):
        worst_f[kind_] = 0.0
        deep = qc_decoder(Hz, kind_, C5_ITER, C5_SCHEDULE, stacked=True)
        out = compare_flood(f"flood_qc {kind_} {CODE} side X p={C5_P}", deep,
                            syn5, lch5, 5)
        f_times[kind_] = out
        worst_f[kind_] = max(worst_f[kind_], out[2])
        check(out[3], f"kernel F {kind_} == plain ({CODE}, {C5_ITER} it)")
        # a thread per variable: max(m, n) threads, phase 2 in one pass
        wide = qc_decoder(Hz, kind_, C5_ITER, C5_SCHEDULE, stacked=True)
        wide.flood_threads = min(1024, -(-max(wide.tabs.m, wide.tabs.n)
                                          // 32) * 32)
        out_w = compare_flood(f"flood_qc {kind_} {CODE} side X p={C5_P}, "
                              f"{wide.flood_threads} threads", wide, syn5,
                              lch5, 5)
        worst_f[kind_] = max(worst_f[kind_], out_w[2])
        check(out_w[3], f"kernel F {kind_} with {wide.flood_threads} "
              f"threads == plain ({CODE})")
        print(f"  kernel F {kind_} {BATCH} x {C5_ITER}: the plan's "
              f"{deep.flood_threads} threads {out[0]:.4f} ms, a thread per "
              f"variable ({wide.flood_threads} threads) {out_w[0]:.4f} ms; "
              f"before the redesign {OLD[f'F {kind_} 4096x99 ms']} ms  "
              f"[{smi}]")
        head = qc_decoder(Hz, kind_, GH_HEAD_ITER, "F", stacked=True)
        out = compare_flood(f"flood_qc {kind_} {CODE} cascade head", head,
                            syn5, lch5, 5)
        worst_f[kind_] = max(worst_f[kind_], out[2])
        check(out[3], f"kernel F {kind_} == plain ({CODE}, head)")
        kc = flood_qc_cuda.flood_qc_cuda(head, syn5, lch5)[2]
        tail = torch.nonzero(~kc).flatten()[:GH_TAIL_SHOTS]
        check(tail.numel() == GH_TAIL_SHOTS, "the head left a tail window")
        out = compare_flood(f"flood_qc {kind_} {CODE} tail window", deep,
                            syn5[tail].contiguous(), lch5, 5)
        worst_f[kind_] = max(worst_f[kind_], out[2])
        check(out[3], f"kernel F {kind_} == plain ({CODE}, tail window)")
        for label, H, syn_, lch_, iters in (
                ("tanner", Tz, syn_tan, lch_seq, C4_ITER),
                ("lp04_0", L4z, syn_l4, lch5, 30)):
            out = compare_flood(
                f"flood_qc {kind_} {label} side X",
                qc_decoder(H, kind_, iters, "F", stacked=True), syn_, lch_, 5)
            worst_f[kind_] = max(worst_f[kind_], out[2])
            check(out[3], f"kernel F {kind_} == plain ({label})")
        e_diff, i_diff, c_diff = beside_b(
            f"{kind_}-F {C5_ITER} it, {CODE} side X, B={BATCH}, p={C5_P}", Hz,
            kind_, C5_ITER, syn5, lch5)
        # the two kernels associate differently (tree against left fold,
        # deltas summed first against one by one): last-bit differences that
        # a shot which never converges can amplify
        check(max(e_diff, i_diff, c_diff) <= BATCH // 50,
              f"{kind_}: kernels F and B decide alike on at least 98 % of "
              "shots")
        # a lone shot that runs every iteration
        ki = flood_qc_cuda.flood_qc_cuda(deep, syn5, lch5)[1]
        slow = torch.nonzero(ki == C5_ITER).flatten()
        check(slow.numel() > 0, "a shot ran every iteration")
        one = syn5[slow[:1]].contiguous()
        one_T = one.T.contiguous()
        db = qc_decoder(Hz, kind_, C5_ITER, "F")
        it_f = int(flood_qc_cuda.flood_qc_cuda(deep, one, lch5)[1][0])
        it_b = int(ms_qc_cuda.ms_qc_cuda(db, one_T, lch5)[1][0])
        post1 = flood_qc_cuda.flood_qc_cuda(deep, one, lch5)
        t = deep.tabs
        one_bound = bound(nbytes(one, *post1),
                          t.n_slots * t.L * it_f * (OPS_MS if kind_ == "MS"
                                                    else OPS_BP))
        for dec_ in (deep, wide):
            lone_f = cuda_ms(
                lambda: flood_qc_cuda.flood_qc_cuda(dec_, one, lch5), 20)
            print(f"{kind_}-F, a lone shot, kernel F with "
                  f"{dec_.flood_threads} threads: {lone_f:.4f} ms for {it_f} "
                  f"iterations = {1e3 * lone_f / it_f:.3f} us per iteration "
                  f"(launch included; before the redesign "
                  f"{OLD[f'F {kind_} lone us/it']}; bound "
                  f"{1e3 * one_bound[0] / it_f:.6f} us per iteration, "
                  f"{one_bound[1]})  [{smi}]")
        lone_b = cuda_ms(lambda: ms_qc_cuda.ms_qc_cuda(db, one_T, lch5), 2)
        print(f"{kind_}-F, a lone shot: kernel B {lone_b:.3f} ms for {it_b} = "
              f"{1e3 * lone_b / it_b:.1f} us per iteration  [{smi}]")

    # 22. kernel B with the check after every layer group
    phase("22 kernel B, check after every layer group")
    syn50 = syndromes_at(P_POINT)["X"].T.contiguous()
    layer_times = {}
    for kind_ in ("MS", "BP"):
        dec = qc_decoder(Hz, kind_, MAX_ITER, SCHEDULE, chk="layer")
        check(dec.track_mis, "the layered schedule has several groups")
        k_ms, p_ms, err, same, bnd = compare_qc(
            f"ms_qc {kind_} {SCHEDULE} check-every-layer side X", dec, syn50,
            lch, 3)
        check(same, f"kernel B {kind_} with the per-layer check == plain")
        di = qc_decoder(Hz, kind_, MAX_ITER, SCHEDULE)
        i_ms = cuda_ms(lambda: ms_qc_cuda.ms_qc_cuda(di, syn50, lch), 3)
        li = ms_qc_cuda.ms_qc_cuda(dec, syn50, lch)
        ii = ms_qc_cuda.ms_qc_cuda(di, syn50, lch)
        layer_times[kind_] = (k_ms, i_ms)
        more_qc_shapes(kind_, chk="layer")
        print(f"  beside one check per iteration: {k_ms:.3f} ms against "
              f"{i_ms:.3f} ms; n_iter differs on "
              f"{int((li[1] != ii[1]).sum())} shots, converged on "
              f"{int((li[2] != ii[2]).sum())}, e_hat on "
              f"{int(((li[0] < 0) != (ii[0] < 0)).any(dim=0).sum())}  [{smi}]")

    # 23. the command line, with kernel F opted in
    phase("23 command line (config 5 and MS-F-50 through cli.main, kernel F)")
    import contextlib
    import io
    import tempfile

    from qldpcsim_torch import cli

    os.environ["QLDPC_QC_STACKED"] = "1"   # read when a decoder is built

    def run_cli(argv):
        """cli.main(argv + --out) -> (the rows of --out, the printed text)."""
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "out.jsonl")
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = cli.main([*argv, "--out", path])
            check(rc == 0, f"cli.main returned {rc}")
            with open(path) as f:
                rows = [json.loads(line) for line in f]
        check("SIMULATION RESULTS" in text.getvalue(), "the CLI's table")
        return rows, text.getvalue()

    def qbler_close(a, b, shots_a, shots_b, what):
        pool = (a * shots_a + b * shots_b) / (shots_a + shots_b)
        sigma = math.sqrt(max(pool * (1 - pool), 1e-12)
                          * (1 / shots_a + 1 / shots_b))
        print(f"  {what}: {a!r} vs {b!r}, |diff| {abs(a - b)!r} vs 4 sigma "
              f"{4 * sigma!r}")
        check(abs(a - b) <= 4 * sigma, what)

    c5_args = ["--code", CODE, "--p", str(C5_P), "--decType", "BP",
               "--decSchedule", C5_SCHEDULE, "--decIterations", str(C5_ITER),
               "--OSDorder", str(C5_ORDER), "--batch", str(BATCH),
               "--rngSeed", str(SEED), "--quiet"]
    reset_launches()
    rows, text = run_cli([*c5_args, "--shots", str(C5_SHOTS)])
    launches_cli = read_launches()
    row5 = rows[0]
    print(text[text.index("   Command line arguments:"):].rstrip())
    print(f"config 5 through cli.main with kernel F: {C5_SHOTS} shots in "
          f"{C5_SHOTS // BATCH} chunks; launches {launches_cli}")
    print(f"  --out row {json.dumps(row5)}")
    print(f"  warm {row5['shots_per_s_warm']:.1f} shots/s (phase 9, kernel B: "
          f"{res5.shots_per_s_warm:.1f})  [{smi}]")
    check(launches_cli["channel"] > 0 and launches_cli["flood_qc BP"] > 0
          and launches_cli["gf2_elim"] > 0,
          "kernels A, F (BP) and C launched on the command line's path")
    check(launches_cli["ms_qc BP"] == 0 and launches_cli["ms_qc MS"] == 0
          and launches_cli["flood_qc MS"] == 0,
          "kernel B not launched when kernel F is opted in")
    check(row5["shots"] == C5_SHOTS and math.isfinite(row5["qBLER"])
          and 1.0 <= row5["Avg_number_of_iterations_X"] <= C5_ITER,
          "the CLI's row is finite and of the expected shape")
    qbler_close(row5["qBLER"], res5.qbler, C5_SHOTS, C5_SHOTS,
                "config 5 qBLER, kernel F through the CLI against phase 9")
    # chunk breakdowns: OSD in the chunk, and the group-level pass
    pipeF = ShotPipeline(Hx, Hz, cfg5)
    check(pipeF.dec_x.decs[0].stacked, "the pipeline's decoders take kernel F")
    for d in (pipeF.dec_x, pipeF.dec_z):
        d.stage_lanes = [0] * len(d.stages)
    before, pipeF.osd_syncs = gf2_elim_cuda.LAUNCHES, 0
    breakdown(pipeF, C5_P, ("channel", "decode X", "decode Z", "OSD",
                            "classify"), smi)
    print(f"  OSD in the chunk: {pipeF.osd_syncs / BREAKDOWN_CHUNKS:.2f} host "
          f"syncs and {(gf2_elim_cuda.LAUNCHES - before) / BREAKDOWN_CHUNKS:.2f}"
          f" kernel C launches per chunk; lanes per cascade stage "
          f"{pipeF.dec_x.stages}: X {pipeF.dec_x.stage_lanes}")
    key_p = fold_in(prng_key(SEED, device=dev), 0)
    names = ("channel", "decode X", "decode Z", "classify + defer")
    spans = np.zeros(len(names))
    pending = []
    before, pipeF.osd_syncs = gf2_elim_cuda.LAUNCHES, 0
    valid = torch.ones(BATCH, dtype=torch.bool, device=dev)
    for ci in range(BREAKDOWN_CHUNKS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        kk = chunk_keys(key_p, ci * tpc, tpc)
        ev[0].record()
        ex, ez, sz, sx = pipeF._sample_chunk(kk, C5_P)
        ev[1].record()
        prior5 = np.float32(C5_P) / np.float32(3.0)
        rx = pipeF.dec_x(sz, prior5)
        ev[2].record()
        rz = pipeF.dec_z(sx, prior5)
        ev[3].record()
        defer = pipeF._defer(ex, ez, sz, sx, rx, rz, valid)[1]
        if defer is not None:
            pending.append(defer)
        ev[4].record()
        ev[4].synchronize()
        spans += [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    pipeF._osd_group_finish(pending)
    ev[1].record()
    ev[1].synchronize()
    spans /= BREAKDOWN_CHUNKS
    osd_ms = ev[0].elapsed_time(ev[1]) / BREAKDOWN_CHUNKS
    total = spans.sum() + osd_ms
    parts = ", ".join(f"{nm} {s_:.4f} ({100 * s_ / total:.1f}%)"
                      for nm, s_ in zip(names + ("group OSD pass",),
                                        list(spans) + [osd_ms]))
    print(f"  chunk breakdown with the group-level pass (CUDA events, mean "
          f"of {BREAKDOWN_CHUNKS} chunks, one pass over "
          f"{sum(d['cx'].shape[0] for d in pending)} records, ms): {parts}, "
          f"total {total:.4f}  [{smi}]")
    print(f"  group-level pass: {pipeF.osd_syncs / BREAKDOWN_CHUNKS:.2f} host "
          f"syncs and {(gf2_elim_cuda.LAUNCHES - before) / BREAKDOWN_CHUNKS:.2f}"
          f" kernel C launches per chunk")
    # the first chunks on the CPU and the card, both through the CLI
    cross = {}
    for device in ("cpu", "cuda"):
        t0 = time.perf_counter()
        cross[device] = run_cli([*c5_args, "--shots",
                                 str(CROSS_CHUNKS * BATCH), "--device",
                                 device])[0][0]
        print(f"config 5 by CLI, first {CROSS_CHUNKS} chunks, {device}: "
              f"{ {k: cross[device][k] for k in res5.counters} } "
              f"({time.perf_counter() - t0:.1f} s)")
    qbler_close(cross["cuda"]["qBLER"], cross["cpu"]["qBLER"],
                CROSS_CHUNKS * BATCH, CROSS_CHUNKS * BATCH,
                "config 5 by CLI, card against CPU")
    # min-sum through the same entry point: counters are device-independent
    ms_args = ["--code", CODE, "--p", str(P_POINT), "--decType", "MS",
               "--decSchedule", "F", "--decIterations", str(MAX_ITER),
               "--batch", str(BATCH), "--rngSeed", str(SEED), "--quiet"]
    reset_launches()
    rows, _ = run_cli([*ms_args, "--shots", str(SHOTS)])
    launches_cli_ms = read_launches()
    print(f"MS-F-{MAX_ITER} p={P_POINT} through cli.main with kernel F: "
          f"{SHOTS} shots; launches {launches_cli_ms}")
    print(f"  --out row {json.dumps(rows[0])}")
    print(f"  warm {rows[0]['shots_per_s_warm']:.1f} shots/s  [{smi}]")
    check(launches_cli_ms["flood_qc MS"] > 0
          and launches_cli_ms["ms_qc MS"] == 0,
          "kernel F (MS) launched on the command line's min-sum path")
    timing = ("wall_time_s", "shots_per_s", "warm_time_s", "shots_per_s_warm")
    cross_ms = {}
    for device in ("cpu", "cuda"):
        r = run_cli([*ms_args, "--shots", str(CROSS_CHUNKS * BATCH),
                     "--device", device])[0][0]
        cross_ms[device] = {k: v for k, v in r.items() if k not in timing}
        print(f"MS-F by CLI, first {CROSS_CHUNKS} chunks, {device}: "
              f"{cross_ms[device]}")
    check(cross_ms["cpu"] == cross_ms["cuda"],
          "MS-F through the CLI: GPU counters == CPU counters")
    # the module entry point, in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.jsonl")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "qldpcsim_torch", *c5_args, "--shots",
             str(BATCH), "--out", path], cwd=HERE, capture_output=True,
            text=True, timeout=300,
            env=dict(os.environ, PYTHONPATH=HERE))
        check(proc.returncode == 0,
              f"python -m qldpcsim_torch: rc {proc.returncode}\n"
              f"{proc.stderr[-2000:]}")
        with open(path) as f:
            sub_row = json.loads(f.readline())
    table = proc.stdout[proc.stdout.index("SIMULATION RESULTS"):]
    cells = table.strip().splitlines()[-1].split("|")
    print(f"python3 -m qldpcsim_torch ({BATCH} shots, "
          f"{time.perf_counter() - t0:.1f} s): table row "
          f"{[c_.strip() for c_ in cells]}; --out qBLER {sub_row['qBLER']!r}")
    check(len(cells) == 5 and float(cells[0]) == C5_P
          and abs(float(cells[1]) - sub_row["qBLER"]) <= 5e-3 * max(
              sub_row["qBLER"], 1e-3) + 1e-9,
          "the module's table agrees with its --out file")
    check(sub_row["shots"] == BATCH and 0.0 <= sub_row["qBLER"] < 0.5,
          "the module's --out row")
    del os.environ["QLDPC_QC_STACKED"]

    # 24. validate_encoding, and the compat shims on the card
    phase("24 validate_encoding and the compat shims")
    reset_launches()
    r = simulate_p(Hx, Hz, P_POINT, dataclasses.replace(
        cfg, shots=CROSS_CHUNKS * BATCH, validate_encoding=True))
    check(channel_cuda.LAUNCHES == CROSS_CHUNKS
          and channel_cuda.SYN_LAUNCHES == 0,
          "validate_encoding: kernel A draws the errors alone, once a chunk")
    framed = dict(r.counters, nIterAccX=r.avg_iterations_x * r.shots,
                  nIterAccZ=r.avg_iterations_z * r.shots)
    print(f"validate_encoding, first {CROSS_CHUNKS} chunks of the flagship: "
          f"{framed}")
    check(framed == small["cuda"],
          "validate_encoding leaves the flagship's counters as they are")
    from qldpcsim_torch.compat import decoders as compat_decoders

    # a light syndrome (its weight the least above zero): every decoder's
    # easy case
    weight = syn5.sum(dim=1)
    weight[weight == 0] = syn5.shape[1]
    one_syn = syn5[int(weight.argmin())].cpu().numpy().astype(np.int64)
    Hz64 = Hz.astype(np.int64)
    reset_launches()
    for name, args, kw in (
            ("NG_decoder", (), {}), ("BF_decoder", (), {}),
            ("MS_decoder", (C5_P / 3,), {"max_iter": 50}),
            ("BP_decoder", (C5_P / 3,), {"max_iter": 50, "OSDorder": 2})):
        e, it = getattr(compat_decoders, name)(Hz, one_syn, *args, **kw)
        ok = bool((((Hz64 @ e.astype(np.int64)) % 2) == one_syn).all())
        print(f"compat.{name} on the card: weight {int(e.sum())}, {it} "
              f"iterations, syndrome satisfied {ok}")
        check(e.shape == (n,) and it >= 0, f"compat.{name} returns (e, it)")
        if name in ("MS_decoder", "BP_decoder"):
            check(ok, f"compat.{name} solves a light syndrome")
    e = compat_decoders.OSDdec(Hz, np.zeros(n, np.int64), one_syn,
                               np.full(n, 3.0, np.float32), 2)
    check(bool((((Hz64 @ e.astype(np.int64)) % 2) == one_syn).all()),
          "compat.OSDdec satisfies the syndrome")
    la = read_launches()
    print(f"compat launches {la}")
    check(la["ms_qc MS"] > 0 and la["ms_qc BP"] > 0 and la["gf2_elim"] > 0,
          "the compat shims ran kernels B and C on the card")

    # 25. kernel B with the bf16 state against its plain version
    phase("25 kernel B with the bf16 state (QLDPC_QC_DTYPE=bf16), MS and BP")
    from qldpcsim_torch.engine.montecarlo import _decoder_choice

    BF16 = torch.bfloat16
    syn5_T = syn5.T.contiguous()

    def variant(H_or_st, kind_, max_iter, sched, dtype=BF16, vec=False,
                stacked=False, chk="iter"):
        """A QC decoder on the card with the state's dtype, the writeback
        and kernel F given here (the environment is not read)."""
        if isinstance(H_or_st, np.ndarray):
            st, layers = detect_qc(H_or_st), build_layers(H_or_st, sched)
        else:
            st, layers = H_or_st, None
        return ms_qc_cuda.make_qc_decoder(
            st, DecoderConfig(dec_type=kind_, max_iter=max_iter,
                              schedule=sched, qc_check_every=chk),
            layers=layers, device=dev, stacked=stacked, dtype=dtype, vec=vec)

    def smem_line(dec):
        """Shared memory per shot (one block) and blocks per SM."""
        words = dec.table_words + (0 if dec.state_on_device
                                   else dec.state_words)
        return (f"{4 * words} B shared per shot, "
                f"{ms_qc_cuda.blocks_per_sm(dec)} blocks per SM")

    bf_b, worst_bf = {}, {"MS": 0.0, "BP": 0.0}
    for label, H, kind_, iters, sched, syn_T, lch_, chk in (
            (f"MS-{SCHEDULE}-{MAX_ITER} (the flagship's shape)", Hz, "MS",
             MAX_ITER, SCHEDULE, syn50, lch, "iter"),
            (f"MS-F-{C5_ITER} (config 5's shape)", Hz, "MS", C5_ITER, "F",
             syn5_T, lch5, "iter"),
            (f"BP-F-{C5_ITER} (config 5's shape)", Hz, "BP", C5_ITER, "F",
             syn5_T, lch5, "iter"),
            (f"MS-{SCHEDULE}-{MAX_ITER}, check after every layer group", Hz,
             "MS", MAX_ITER, SCHEDULE, syn50, lch, "layer")):
        d16 = variant(H, kind_, iters, sched, chk=chk)
        d32 = variant(H, kind_, iters, sched, dtype=torch.float32, chk=chk)
        check(d16.track_mis == (chk == "layer") and not d16.state_on_device,
              f"bf16 {label}: the decoder's decisions")
        out = compare_qc(f"ms_qc {kind_} bf16 {label} side X", d16, syn_T,
                         lch_, 5)
        check(out[3], f"kernel B {kind_} bf16 == plain bf16 ({label})")
        worst_bf[kind_] = max(worst_bf[kind_], out[2])
        f32_ms = cuda_ms(lambda: ms_qc_cuda.ms_qc_cuda(d32, syn_T, lch_), 5)
        print(f"  bf16 {out[0]:.4f} ms against float32 {f32_ms:.4f} ms; "
              f"bf16: {smem_line(d16)}; float32: {smem_line(d32)}  [{smi}]")
        bf_b.setdefault(kind_, out)
    # a synthetic lift whose state lies in device memory in bf16 too
    st_big = synthetic_lift("oversize")
    for kind_ in ("MS", "BP"):
        d16 = variant(st_big, kind_, 6, "F")
        check(d16.state_on_device, "the oversize lift's bf16 state lies in "
              "device memory")
        syn_big = syn_of(st_big.lift(), 0.01)[:, :256].contiguous()
        out = compare_qc(f"ms_qc {kind_} bf16 oversize lift, state in "
                         f"device memory", d16, syn_big, lch5, 3)
        check(out[3], f"kernel B {kind_} bf16 == plain bf16 (device state)")
        worst_bf[kind_] = max(worst_bf[kind_], out[2])

    # 26. kernel F with the bf16 state against its plain version
    phase("26 kernel F with the bf16 state, MS and BP")
    bf_f, worst_bff = {}, {"MS": 0.0, "BP": 0.0}
    st_bf = bf16_only_lift()
    syn_bf = syn_of(st_bf.lift(), 0.002).T.contiguous()     # (B, m)
    for kind_ in ("MS", "BP"):
        d16 = variant(Hz, kind_, C5_ITER, "F", stacked=True)
        d32 = variant(Hz, kind_, C5_ITER, "F", dtype=torch.float32,
                      stacked=True)
        check(d16.stacked and d32.stacked, "kernel F taken")
        out = compare_flood(f"flood_qc {kind_} bf16 {CODE} side X p={C5_P}",
                            d16, syn5, lch5, 5)
        check(out[3], f"kernel F {kind_} bf16 == plain bf16 ({CODE})")
        worst_bff[kind_] = max(worst_bff[kind_], out[2])
        bf_f[kind_] = out
        f32_ms = cuda_ms(lambda: flood_qc_cuda.flood_qc_cuda(d32, syn5,
                                                             lch5), 5)
        print(f"  bf16 {out[0]:.4f} ms against float32 {f32_ms:.4f} ms; "
              f"shared memory per shot: bf16 "
              f"{flood_qc_cuda.smem_bytes(d16.tabs, BF16)} B, float32 "
              f"{flood_qc_cuda.smem_bytes(d32.tabs)} B  [{smi}]")
        # a lift that kernel F takes only in bf16
        f16 = variant(st_bf, kind_, 20, "F", stacked=True)
        f32 = variant(st_bf, kind_, 20, "F", dtype=torch.float32,
                      stacked=True)
        check(f16.stacked and not f32.stacked and f32.state_on_device,
              "the lift goes to kernel F in bf16 only (to kernel B with "
              "its state in device memory in float32)")
        out = compare_flood(f"flood_qc {kind_} bf16 lift 128 x (27 x 8), "
                            f"{flood_qc_cuda.smem_bytes(f16.tabs, BF16)} B "
                            f"(float32 {flood_qc_cuda.smem_bytes(f16.tabs)} "
                            f"B)", f16, syn_bf, lch5, 3)
        check(out[3], f"kernel F {kind_} bf16 == plain bf16 (the lift)")
        worst_bff[kind_] = max(worst_bff[kind_], out[2])

    # 27. kernel B with the stacked-update writeback against its plain
    # version
    phase("27 kernel B with the stacked-update writeback (QLDPC_QC_VEC=1)")
    vec_b, worst_vec = {}, 0.0
    for sched in (SCHEDULE, "F"):
        dv = variant(Hz, "MS", MAX_ITER, sched, dtype=torch.float32,
                     vec=True)
        ds = variant(Hz, "MS", MAX_ITER, sched, dtype=torch.float32)
        check(dv.vec and not ds.vec, "the writeback taken by keyword")
        out = compare_qc(f"ms_qc MS vec {sched} side X", dv, syn50, lch, 5)
        check(out[3], f"kernel B vec == plain vec ({sched})")
        worst_vec = max(worst_vec, out[2])
        vec_b.setdefault(sched, out)
        s_ms = cuda_ms(lambda: ms_qc_cuda.ms_qc_cuda(ds, syn50, lch), 5)
        vp, vi, vc = ms_qc_cuda.ms_qc_cuda(dv, syn50, lch)
        sp, si, sc = ms_qc_cuda.ms_qc_cuda(ds, syn50, lch)
        print(f"  vec {out[0]:.4f} ms against the per-slot writeback "
              f"{s_ms:.4f} ms; against it: e_hat differs on "
              f"{int(((vp < 0) != (sp < 0)).any(dim=0).sum())} shots, n_iter "
              f"on {int((vi != si).sum())}, max|post diff| "
              f"{float((vp - sp).abs().max())}  [{smi}]")
        for on_device in (False, True):
            dv.state_on_device = on_device
            for per_edge in (True, False):
                dv.per_edge = per_edge
                check_qc(f"vec {sched}", dv, syn50[:, :300].contiguous(),
                         lch)

    # 28. the main paths with the variants, through simulate_p: the counts
    # set to 0 just before each run and read just after
    phase("28 main paths with the bf16 state and the writeback")
    flags = ("QLDPC_QC_DTYPE", "QLDPC_QC_STACKED", "QLDPC_QC_VEC")

    def with_env(env, fn):
        """fn() with exactly `env` of the three flags in the environment
        (decoders read them when they are built)."""
        saved = {k: os.environ.pop(k, None) for k in flags}
        os.environ.update(env)
        try:
            return fn()
        finally:
            for k in flags:
                os.environ.pop(k, None)
                if saved[k] is not None:
                    os.environ[k] = saved[k]

    def variant_run(label, env, cfg_, p_, want, base, exact):
        """The path under `env`: its decoder choice, launches (kernel A fused
        once a chunk, the variant's counter), qBLER against the float32
        run's, a timed run, and the first chunks on the CPU against the card
        (counters equal for MS, qBLER within 4 sigma for BP)."""
        def run():
            pipe_ = ShotPipeline(Hx, Hz, cfg_)
            choice = _decoder_choice(pipe_.dec_x)
            check(choice == want, f"{label}: decoder {choice}, want {want}")
            reset_launches()
            r_ = simulate_p(Hx, Hz, p_, cfg_, pipeline=pipe_)
            la_ = read_launches()
            var = {"B bf16": dict(ms_qc_cuda.BF16_LAUNCHES),
                   "F bf16": dict(flood_qc_cuda.BF16_LAUNCHES),
                   "B vec": ms_qc_cuda.VEC_LAUNCHES}
            check_fused(la_, label)
            print(f"{label}: {cfg_.shots} shots; decoder {choice}; launches "
                  f"{ {k: v for k, v in la_.items() if v} }, variants {var}")
            print(f"  counters {json.dumps(r_.counters)}; qBLER {r_.qbler!r}"
                  f" (float32: {base.qbler!r}); warm {r_.shots_per_s_warm:.1f}"
                  f" shots/s (float32: {base.shots_per_s_warm:.1f})  [{smi}]")
            qbler_close(base.qbler, r_.qbler, base.shots, r_.shots,
                        f"{label}: qBLER within 4 sigma of the float32 run's")
            timed = timed_run(label, Hx, Hz, p_, cfg_, pipe_, TIMED_SHOTS,
                              "not applicable; the float32 path's timed run "
                              "is printed in its own phase")
            cross = {}
            n_cross = CROSS_CHUNKS if exact else 1   # BP's CPU run is slow
            for device in ("cpu", "cuda"):
                rc = simulate_p(Hx, Hz, p_, dataclasses.replace(
                    cfg_, shots=n_cross * BATCH, device=device))
                cross[device] = rc
            if exact:
                same = (cross["cpu"].counters == cross["cuda"].counters
                        and cross["cpu"].avg_iterations_x
                        == cross["cuda"].avg_iterations_x)
                print(f"  first {CROSS_CHUNKS} chunks, CPU (plain) against "
                      f"the card: counters equal {same}")
                check(same, f"{label}: card counters == CPU counters")
            else:
                qbler_close(cross["cpu"].qbler, cross["cuda"].qbler,
                            n_cross * BATCH, n_cross * BATCH,
                            f"{label}: first {n_cross} chunk(s), card "
                            "against CPU")
            return r_, la_, var, timed, cross["cuda"]
        return with_env(env, run)

    cfg_f = dataclasses.replace(cfg, dec_schedule="F")
    base_f = simulate_p(Hx, Hz, P_POINT, cfg_f)   # MS-F-50, kernel B, f32
    runs = {}
    runs["flagship bf16"] = variant_run(
        f"flagship bf16 (MS-{SCHEDULE}-{MAX_ITER})",
        {"QLDPC_QC_DTYPE": "bf16"}, cfg, P_POINT, "QCDecoder:bf16", res,
        True)
    runs["config 5 bf16"] = variant_run(
        "config 5 bf16 on kernel B", {"QLDPC_QC_DTYPE": "bf16"}, cfg5, C5_P,
        "QCDecoder:bf16", res5, False)
    runs["config 5 bf16 F"] = variant_run(
        "config 5 bf16 on kernel F",
        {"QLDPC_QC_DTYPE": "bf16", "QLDPC_QC_STACKED": "1"}, cfg5, C5_P,
        "QCDecoder:stacked:bf16", res5, False)
    runs["MS-F bf16 F"] = variant_run(
        f"MS-F-{MAX_ITER} bf16 on kernel F",
        {"QLDPC_QC_DTYPE": "bf16", "QLDPC_QC_STACKED": "1"}, cfg_f, P_POINT,
        "QCDecoder:stacked:bf16", base_f, True)
    runs["flagship vec"] = variant_run(
        f"flagship vec (MS-{SCHEDULE}-{MAX_ITER})", {"QLDPC_QC_VEC": "1"},
        cfg, P_POINT, "QCDecoder:vec", res, True)
    vec_small = runs["flagship vec"][4]
    vec_counts = dict(vec_small.counters,
                      nIterAccX=vec_small.avg_iterations_x * vec_small.shots,
                      nIterAccZ=vec_small.avg_iterations_z * vec_small.shots)
    print(f"  the writeback's first {CROSS_CHUNKS} chunks against the "
          f"default run's (phase 8): counters equal "
          f"{vec_counts == small['cuda']}")
    check(runs["flagship bf16"][2]["B bf16"]["MS"] > 0
          and runs["config 5 bf16"][2]["B bf16"]["BP"] > 0
          and runs["config 5 bf16 F"][2]["F bf16"]["BP"] > 0
          and runs["config 5 bf16 F"][1]["ms_qc BP"] == 0
          and runs["MS-F bf16 F"][2]["F bf16"]["MS"] > 0
          and runs["flagship vec"][2]["B vec"] > 0,
          "every variant's kernel launched on its path")
    check(all(k not in os.environ for k in flags), "the flags are unset")
    # 29. the group-deferred cascade: each pipeline built with the gate in
    # the environment, its counters held to the in-chunk cascade's on the
    # same shots, the counts set to 0 just before each run
    phase("29 group cascade (QLDPC_GROUP_CASCADE=1)")
    from qldpcsim_torch.engine import group_cascade

    gate = {group_cascade.ENV: "1"}
    stacked = {"QLDPC_QC_STACKED": "1"}

    def build(Hx_, Hz_, cfg_, env):
        """A pipeline built with exactly `env` of the gate and
        QLDPC_QC_STACKED (both are read when it is built)."""
        names_ = (group_cascade.ENV, "QLDPC_QC_STACKED")
        saved = {k: os.environ.pop(k, None) for k in names_}
        os.environ.update(env)
        try:
            return ShotPipeline(Hx_, Hz_, cfg_)
        finally:
            for k in names_:
                os.environ.pop(k, None)
                if saved[k] is not None:
                    os.environ[k] = saved[k]

    def counters_of(r):
        return dict(r.counters, avg_x=r.avg_iterations_x,
                    avg_z=r.avg_iterations_z)

    real_nonzero = torch.nonzero
    nonzero_calls = [0]

    def counting_nonzero(*a, **k):
        nonzero_calls[0] += 1
        return real_nonzero(*a, **k)

    def counted(label, Hx_, Hz_, p_, cfg_, pipe_, p_index=0):
        """simulate_p on pipe_ with every count at 0 just before: the result,
        the launches and the host syncs (torch.nonzero calls) per chunk."""
        gc = pipe_.group_cascade
        if gc is not None:
            gc.deferred = gc.gc_overflows = gc.syncs = 0
            gc.tail_lanes = {"x": 0, "z": 0}
            gc.tail_windows = {"x": 0, "z": 0}
        for casc in ((gc.head_x, gc.head_z) if gc is not None
                     else (pipe_.dec_x, pipe_.dec_z)):
            if hasattr(casc, "stage_lanes"):
                casc.stage_lanes = [0] * len(casc.stages)
        pipe_.osd_syncs = 0
        reset_launches()
        nonzero_calls[0] = 0
        torch.nonzero = counting_nonzero
        try:
            r = simulate_p(Hx_, Hz_, p_, cfg_, pipeline=pipe_,
                           p_index=p_index)
        finally:
            torch.nonzero = real_nonzero
        la = read_launches()
        check_fused(la, label)
        n_ch = -(-cfg_.shots // pipe_.batch)
        per = {k: round(v / n_ch, 2) for k, v in la.items() if v}
        print(f"{label}: {cfg_.shots} shots in {n_ch} chunks; counters "
              f"{json.dumps(r.counters)}, avg iterations X "
              f"{r.avg_iterations_x!r} Z {r.avg_iterations_z!r}; launches "
              f"per chunk {per}; host syncs (torch.nonzero) per chunk "
              f"{nonzero_calls[0] / n_ch:.2f}")
        if gc is not None:
            lanes = (f"head stage lanes {gc.head_x.stages}: X "
                     f"{gc.head_x.stage_lanes}, Z {gc.head_z.stage_lanes}; "
                     if hasattr(gc.head_x, "stage_lanes") else
                     f"head: the plain {gc.head_x.max_iter}-iteration "
                     "decoder; ")
            print(f"  group cascade: {lanes}records deferred {gc.deferred}; "
                  f"overflowed chunks {gc.gc_overflows} of {n_ch} (cap "
                  f"{gc.defer_cap}); tail lanes X {gc.tail_lanes['x']} Z "
                  f"{gc.tail_lanes['z']} in windows X "
                  f"{gc.tail_windows['x']} Z {gc.tail_windows['z']} (of at "
                  f"most {gc.window}); its own host syncs "
                  f"{gc.syncs / n_ch:.2f} per chunk; OSD's "
                  f"{pipe_.osd_syncs / n_ch:.2f}")
        else:
            casc = pipe_.dec_x
            if hasattr(casc, "stage_lanes"):
                print(f"  in-chunk cascade: lanes per stage {casc.stages}: X "
                      f"{casc.stage_lanes}, Z {pipe_.dec_z.stage_lanes}")
        return r, la

    def warm_pair(label, Hx_, Hz_, p_, cfg_, pipes, shots_, p_index=0,
                  rounds=1):
        """Warm shots/s of each pipeline of `pipes` (name -> pipeline) on
        the same `shots_` shots, in turns, `rounds` times."""
        rates = {k: [] for k in pipes}
        for _ in range(rounds):
            for name_, pipe_ in pipes.items():
                r = simulate_p(Hx_, Hz_, p_, dataclasses.replace(
                    cfg_, shots=shots_), pipeline=pipe_, p_index=p_index)
                check(r.shots == shots_ and 0.0 <= r.qbler <= 1.0,
                      f"timed run {label} {name_}")
                rates[name_].append((r.shots_per_s_warm, r.warm_time_s,
                                     r.qbler))
        print(f"  timed, {label}, {shots_} shots: " + "; ".join(
            f"{name_} " + ", ".join(f"{v:.1f} shots/s ({w:.3f} s warm)"
                                    for v, w, _ in rs)
            for name_, rs in rates.items()) + f"  [{smi}]")
        qs = {rs[0][2] for rs in rates.values()}
        check(len(qs) == 1, f"timed {label}: the same qBLER on every path")
        return rates

    def gc_breakdown(label, pipe_, p_, chunks, p_index=0):
        """Mean CUDA-event ms of a group-cascade chunk's spans over `chunks`
        full chunks (channel, head X, head Z, classify, the stragglers'
        torch.nonzero with its host sync, the record gathers, a finish an
        overflow forced inside the chunk, and the residual: the chunk's
        time outside every span, which is the card waiting on the host
        between launches), and of one group finish over their records,
        divided by `chunks` (not part of any launch count). A span inside
        another one counts in the outer one alone."""
        gc = pipe_.group_cascade
        key_p = fold_in(prng_key(SEED, device=dev), p_index)
        tpc_ = pipe_.tiles_per_chunk
        spans = {"channel": 0.0, "head X": 0.0, "head Z": 0.0,
                 "classify": 0.0, "nonzero (host sync)": 0.0,
                 "record gathers": 0.0, "finish in the chunk": 0.0,
                 "group finish": 0.0}
        events, where, depth = [], ["finish in the chunk"], [0]

        def wrap(obj, attr, name_):
            f = getattr(obj, attr)

            def timed(*a, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                depth[0] += 1
                try:
                    out = f(*a, **k)
                finally:
                    depth[0] -= 1
                e1.record()
                if depth[0] == 0:
                    events.append((name_ if name_ else where[0], e0, e1))
                return out

            setattr(obj, attr, timed)

        wrap(pipe_, "_sample_chunk", "channel")
        wrap(gc.head_x, "forward", "head X")
        wrap(gc.head_z, "forward", "head Z")
        wrap(pipe_, "classify", "classify")
        wrap(gc, "finish", None)
        wrap(gc, "_records", "record gathers")
        wrap(torch, "nonzero", "nonzero (host sync)")
        chunk_ms, recs = 0.0, []
        try:
            for ci in range(chunks):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                _, rec = gc.chunk(chunk_keys(key_p, ci * tpc_, tpc_), p_,
                                  pipe_.batch)
                e1.record()
                e1.synchronize()
                chunk_ms += e0.elapsed_time(e1)
                if rec is not None:
                    recs.append(rec)
            where[0] = "group finish"
            if recs:
                gc.finish(recs, p_)
            torch.cuda.synchronize()
        finally:
            for obj, attr in ((pipe_, "_sample_chunk"), (pipe_, "classify"),
                              (gc.head_x, "forward"), (gc.head_z, "forward"),
                              (gc, "finish"), (gc, "_records")):
                delattr(obj, attr)
            torch.nonzero = real_nonzero
        for name_, e0, e1 in events:
            spans[name_] += e0.elapsed_time(e1)
        spans["residual (host gaps)"] = chunk_ms - sum(
            v for k, v in spans.items() if k != "group finish")
        order = ("channel", "head X", "head Z", "classify",
                 "nonzero (host sync)", "record gathers",
                 "residual (host gaps)", "finish in the chunk",
                 "group finish")
        total = sum(spans.values()) / chunks
        parts = ", ".join(f"{k} {spans[k] / chunks:.4f} "
                          f"({100 * spans[k] / chunks / total:.1f}%)"
                          for k in order)
        print(f"  {label}: group-cascade chunk breakdown (CUDA events, mean "
              f"of {chunks} chunks, one group finish over "
              f"{sum(r_['cx'].shape[0] for r_ in recs)} records, ms): "
              f"{parts}, total {total:.4f}  [{smi}]")

    t_gc = time.perf_counter()
    # (a) the flagship against phase 7
    pipe_gc = build(Hx, Hz, cfg, gate)
    check(pipe_gc.group_cascade is not None and pipe.group_cascade is None,
          "the gate decides the path when the pipeline is built")
    counted("flagship, in-chunk cascade", Hx, Hz, P_POINT, cfg, pipe)
    r29, la29 = counted("flagship, group cascade", Hx, Hz, P_POINT, cfg,
                        pipe_gc)
    check(counters_of(r29) == counters_of(res),
          "29 flagship: counters and iterations equal to phase 7's")
    check(la29["ms_qc MS"] > 0, "kernel B launched under the group cascade")
    gc_rates = {"flagship": warm_pair(
        "flagship", Hx, Hz, P_POINT, cfg,
        {"in-chunk": pipe, "group cascade": pipe_gc}, TIMED_SHOTS, rounds=3)}
    gc_breakdown("flagship", pipe_gc, P_POINT, BREAKDOWN_CHUNKS)
    # (b) config 4 at p = 0.01 and 0.1 against phase 13's sweep
    pipe4_gc = build(Tx, Tz, cfg4, gate)
    check(not pipe4_gc.group_cascade.head_x.highp_guard
          and pipe4.dec_x.highp_guard,
          "config 4: the head has no high-p guard, the in-chunk cascade has")
    for i in (0, len(C4_P) - 1):
        counted(f"config 4 p={C4_P[i]}, in-chunk cascade", Tx, Tz, C4_P[i],
                cfg4, pipe4, p_index=i)
        r_, la_ = counted(f"config 4 p={C4_P[i]}, group cascade", Tx, Tz,
                          C4_P[i], cfg4, pipe4_gc, p_index=i)
        check(counters_of(r_) == counters_of(res4[i]),
              f"29 config 4 p={C4_P[i]}: counters and iterations equal to "
              "phase 13's")
        check(la_["seq_qc MS"] > 0, "kernel D launched under the gate")
    gc_rates["config 4 p=0.1"] = warm_pair(
        f"config 4 p={C4_P[-1]}", Tx, Tz, C4_P[-1], cfg4,
        {"in-chunk": pipe4, "group cascade": pipe4_gc}, C4_TIMED_SHOTS[-1],
        p_index=len(C4_P) - 1, rounds=2)
    gc_breakdown(f"config 4 p={C4_P[-1]}", pipe4_gc, C4_P[-1],
                 C4_BREAKDOWN_CHUNKS, p_index=len(C4_P) - 1)
    # (c) config 5 on kernels F and C, with and without the gate
    pipe5_f = build(Hx, Hz, cfg5, stacked)
    pipe5_gc = build(Hx, Hz, cfg5, dict(stacked, **gate))
    check(pipe5_f.dec_x.decs[0].stacked
          and pipe5_gc.group_cascade.tail_x.stacked,
          "config 5: both pipelines decode on kernel F")
    r5f, _ = counted("config 5 on kernel F, in-chunk cascade", Hx, Hz, C5_P,
                     cfg5, pipe5_f)
    r5g, la5g = counted("config 5 on kernel F, group cascade", Hx, Hz, C5_P,
                        cfg5, pipe5_gc)
    check(counters_of(r5g) == counters_of(r5f),
          "29 config 5 on kernel F: counters and iterations equal without "
          "the gate")
    print(f"  config 5 on kernel F in this phase against phase 23's "
          f"cli.main run of the same shots: counters equal "
          f"{r5f.counters == {k: row5[k] for k in r5f.counters}}")
    check(la5g["flood_qc BP"] > 0 and la5g["gf2_elim"] > 0
          and la5g["ms_qc BP"] == 0,
          "kernels F (BP) and C launched under the group cascade")
    gc_rates["config 5 F"] = warm_pair(
        "config 5 on kernel F", Hx, Hz, C5_P, cfg5,
        {"in-chunk": pipe5_f, "group cascade": pipe5_gc}, TIMED_SHOTS,
        rounds=2)
    gc_breakdown("config 5 on kernel F", pipe5_gc, C5_P, BREAKDOWN_CHUNKS)
    print(f"phase 29: {time.perf_counter() - t_gc:.1f} s")

    # 30. the native GF(2) core on the card's host
    phase("30 native GF(2) core (QLDPC_NATIVE)")
    from qldpcsim_torch import gf2
    from qldpcsim_torch.gf2 import native

    check(os.environ.get("QLDPC_NATIVE", "1") != "0", "QLDPC_NATIVE unset")
    lib = native.get_lib()
    check(lib is not None and native.LIB_PATH.parent == _build.build_dir(),
          "the native GF(2) core built into the port's build directory")
    print(f"native core {native.LIB_PATH} (ABI {native._abi_version(lib)})")

    def on_numpy(fn):
        os.environ["QLDPC_NATIVE"] = "0"
        try:
            return fn()
        finally:
            del os.environ["QLDPC_NATIVE"]

    def host_s(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    (rk_n, t_rk_n) = host_s(lambda: gf2.rank(Hbig))
    (rr_n, t_rr_n) = host_s(lambda: gf2.rref(Hbig))
    (rk_p, t_rk_p) = on_numpy(lambda: host_s(lambda: gf2.rank(Hbig)))
    (rr_p, t_rr_p) = on_numpy(lambda: host_s(lambda: gf2.rref(Hbig)))
    same = (rk_n == rk_p and list(rr_n[2]) == list(rr_p[2])
            and np.array_equal(rr_n[0], rr_p[0])
            and np.array_equal(rr_n[1], rr_p[1]))
    print(f"1200 x 2400 (phase 6): rank {rk_n} native {1e3 * t_rk_n:.1f} ms, "
          f"numpy {1e3 * t_rk_p:.1f} ms; rref native {1e3 * t_rr_n:.1f} ms, "
          f"numpy {1e3 * t_rr_p:.1f} ms; equal {same} (host clock)")
    check(same, "30: rank and rref equal the numpy path's")
    for label, H_a, H_b, cfg_ in (("flagship", Hx, Hz, cfg),
                                  ("config 4", Tx, Tz, cfg4)):
        t_n = [host_s(lambda: ShotPipeline(H_a, H_b, cfg_))[1]
               for _ in range(2)]
        t_p = [on_numpy(lambda: host_s(
            lambda: ShotPipeline(H_a, H_b, cfg_))[1]) for _ in range(2)]
        print(f"  ShotPipeline construction, {label}: native "
              + ", ".join(f"{t:.3f}" for t in t_n) + " s; QLDPC_NATIVE=0 "
              + ", ".join(f"{t:.3f}" for t in t_p) + f" s (host clock)  "
              f"[{smi}]")
    print(f"phases 29-30: {time.perf_counter() - t_gc:.1f} s")

    # 31. bench_torch.py for the flagship and config 5 on kernel F, its
    # lines held to phase 7's pipeline and phase 23's command line
    phase("31 bench_torch.py (flagship, config5_F)")
    t_bench = time.perf_counter()
    import bench_torch

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = bench_torch.main(["--config", "flagship", "--config",
                               "config5_F", "--shots", str(BENCH_SHOTS)])
    lines = [json.loads(line) for line in text.getvalue().splitlines()]
    check(rc == 0 and [ln["config"] for ln in lines]
          == ["flagship", "config5_F"], f"31: bench_torch.py rc {rc}, "
          f"lines {[ln.get('config') for ln in lines]}")
    keys5 = list(res5.counters)
    same = {}
    r7 = simulate_p(Hx, Hz, P_POINT, dataclasses.replace(
        cfg, shots=BENCH_SHOTS), pipeline=pipe)
    same["flagship"] = (
        {k: lines[0][k] for k in keys5} == r7.counters
        and lines[0]["avg_iters_X"] == r7.avg_iterations_x
        and lines[0]["avg_iters_Z"] == r7.avg_iterations_z)
    os.environ["QLDPC_QC_STACKED"] = "1"
    row23 = run_cli([*c5_args, "--shots", str(BENCH_SHOTS)])[0][0]
    del os.environ["QLDPC_QC_STACKED"]
    same["config5_F"] = (
        {k: lines[1][k] for k in keys5} == {k: row23[k] for k in keys5}
        and lines[1]["avg_iters_X"] == row23["Avg_number_of_iterations_X"]
        and lines[1]["avg_iters_Z"] == row23["Avg_number_of_iterations_Z"])
    for ln in lines:
        lay = ln["layers_ms_per_chunk"]
        print(f"{ln['config']}: {ln['shots']} shots, correct "
              f"{ln['correct']} ({ln['check']['rule']}, "
              f"{ln['check']['shots']} shots, shots decoded otherwise "
              f"{ln['check'].get('differ')}; the timed run "
              f"{ln['timed_check']}), decoders {ln['decoders']}; "
              f"warm {ln['shots_per_s_warm']:.1f} shots/s; counters equal "
              f"to phase {7 if ln['config'] == 'flagship' else 23}'s path: "
              f"{same[ln['config']]}  [{ln['card']}]")
        print("  ms a chunk: " + ", ".join(f"{k} {v:.4f}"
                                            for k, v in lay.items())
              + f"; launches a chunk {ln['launches_per_chunk']}; host "
              f"syncs a chunk {ln['host_syncs_per_chunk']}; idle share "
              f"{ln['idle_share']!r} ({ln['trace_kernels']} kernels, "
              f"busy {ln['busy_ms_per_chunk']!r} of an untraced "
              f"{ln['warm_ms_per_chunk']:.4f}-ms chunk, traced "
              f"{ln['trace_ms_per_chunk']:.4f}); peak memory "
              f"{ln['peak_mem_bytes']} bytes; decode bound share "
              f"{ln['decode_bound_share']!r}; host {ln['host_cpu']}")
        check(ln["correct"] is True, f"31: {ln['config']} is correct")
        check(same[ln["config"]], f"31: {ln['config']}'s counters equal "
              "the same shots through its phase's path")
        check(ln["launches_per_chunk"].get("channel syndromes") == 1.0,
              f"31: {ln['config']} ran kernel A once a chunk")
    check(lines[0]["launches_per_chunk"].get("ms_qc MS", 0) > 0
          and lines[1]["launches_per_chunk"].get("flood_qc BP", 0) > 0
          and lines[1]["launches_per_chunk"].get("gf2_elim", 0) > 0,
          "31: kernels B (flagship), F (BP) and C (config 5) launched")

    # the layer pass under the group cascade: its heads, tails and finish
    # spanned, beside the spans of the pipeline's own cascades, which the
    # group cascade never calls (everything lands in the residual there)
    from qldpcsim_torch.utils import bench as bench_mod

    class CascadeSpans(bench_mod._Spans):
        def targets(self):
            pipe_ = self.pipe
            return ([(pipe_, a, nm) for a, nm in self.WRAPPED]
                    + [(pipe_.dec_x, "forward", "decode_x"),
                       (pipe_.dec_z, "forward", "decode_z")])

    def layer_pass(b, p_, i, spans_cls):
        real = bench_mod._Spans
        bench_mod._Spans = spans_cls
        try:
            return b._layer_pass(p_, i, GC_SPAN_SHOTS)[0]
        finally:
            bench_mod._Spans = real

    for cname, i in (("flagship", 0), ("config4", 1)):
        case = next(c for c in bench_mod.CASES if c.config == cname)
        with bench_mod.environ(((group_cascade.ENV, "1"),)):
            b = bench_mod.Bench(case, case.ps, [GC_SPAN_SHOTS] * len(case.ps),
                                SEED, "cuda", 1, None)
        gc = b.pipe.group_cascade
        check(gc is not None, f"31: {cname} built under the group cascade")
        p_ = case.ps[i]
        b._run(p_, i, b.pipe.batch)      # a warm chunk first
        over0 = gc.gc_overflows
        lay = layer_pass(b, p_, i, bench_mod._Spans)
        over = gc.gc_overflows - over0
        lay_c = layer_pass(b, p_, i, CascadeSpans)
        for label, ly in (("spans of the heads, tails and finish", lay),
                          ("spans of the pipeline's own cascades", lay_c)):
            print(f"  {cname} p={p_}, group cascade, layer pass over "
                  f"{GC_SPAN_SHOTS} shots, {label} (ms a chunk): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in ly.items())
                  + f"  [{smi}]")
        print(f"  {cname}: chunks overflowed in the first pass {over} of "
              f"{GC_SPAN_SHOTS // b.pipe.batch}")
        check(lay["decode_x"] > 0 and lay["decode_z"] > 0
              and lay["finish"] > 0, f"31: {cname} under the group cascade: "
              "decode_x, decode_z and finish above zero")
        check(lay_c["decode_x"] == lay_c["decode_z"] == lay_c["finish"] == 0,
              f"31: {cname}: the pipeline's own cascades never decode under "
              "the group cascade")
        check(lay["residual"] < lay_c["residual"],
              f"31: {cname}: the residual smaller with the group cascade's "
              "spans")
    print(f"phase 31: {time.perf_counter() - t_bench:.1f} s")

    # 32. parity_torch.py: the card's qBLER against the reference-semantics
    # oracle on the host, every row at reduced counts, after a control that
    # must fail
    phase("32 parity_torch.py (BASELINE configs 1-5 against the oracle)")
    t_par = time.perf_counter()
    from qldpcsim_torch.utils import parity

    def parity_row(row):
        return parity.run_one(
            row.name, row.code, row.p, PARITY_ENGINE_SHOTS,
            max(64, int(row.shots_ref * PARITY_SCALE)), row.dec_type,
            row.iters, row.schedule, osd_order=row.osd_order,
            bf_residual=row.bf_residual, device="cuda")

    real_pipeline = parity.ShotPipeline

    def corrupted_pipeline(*a, **k):
        """A pipeline whose X decodes come back as all zeros."""
        pipe_ = real_pipeline(*a, **k)
        forward = pipe_.dec_x.forward

        def zeroed(*fa, **fk):
            r_ = forward(*fa, **fk)
            return dataclasses.replace(r_, e_hat=torch.zeros_like(r_.e_hat))

        pipe_.dec_x.forward = zeroed
        return pipe_

    parity.ShotPipeline = corrupted_pipeline
    try:
        control = parity_row(next(r for r in parity.ROWS
                                  if r.name == PARITY_CONTROL))
    finally:
        parity.ShotPipeline = real_pipeline
    print(f"control, X estimates zeroed: {json.dumps(control)}")
    check(control["pass"] is False,
          f"32: the control ({PARITY_CONTROL}, X estimates zeroed) fails")
    reset_launches()
    par_rows = []
    for row in parity.ROWS:
        line = parity_row(row)
        print(json.dumps(line))
        print(f"  {row.name}: engine {line['seconds_engine']:.2f} s, "
              f"oracle {line['seconds_oracle']:.2f} s (host)")
        par_rows.append(line)
    la_par = read_launches()
    print(f"launches of the ten rows: {la_par}")
    check_fused(la_par, "32 parity rows")
    for line in par_rows:
        check(line["pass"] is True and line["card"] == smi,
              f"32: {line['config']} within {parity.Z} sigma of the oracle")
    check(all(la_par[k] > 0 for k in ("ms_qc MS", "ms_qc BP", "gf2_elim",
                                      "seq_qc MS")),
          "32: kernels B (MS, BP), C and D (MS) launched by the rows")
    print(f"# parity: {len(par_rows)}/{len(par_rows)} within {parity.Z}-"
          f"sigma; max bound {max(r['bound'] for r in par_rows):.4f}  "
          f"[{smi}]")
    print(f"phase 32: {time.perf_counter() - t_par:.1f} s")

    # 33. the cascade on kernel B: one full-depth launch against the stages
    phase("33 the cascade on kernel B: full depth against the stages")
    cascade_paths(smi)
    t_mesh = time.perf_counter()

    # M1. the flagship on a 2-slot mesh of the one card: a host thread per
    # slot, each slot half of every chunk
    phase("M1 flagship on a 2-slot mesh of cuda:0 (one process)")
    mesh2 = make_mesh(["cuda:0", "cuda:0"])
    cfgm = dataclasses.replace(cfg, mesh=mesh2)
    pipem = ShotPipeline(Hx, Hz, cfgm)
    check((pipem.n_dev, pipem.per_dev, pipem.tile) == (2, BATCH // 2, 64),
          "M1 layout: two slots of 2048 shots, 64-shot tiles")
    reset_launches()
    resm = simulate_p(Hx, Hz, P_POINT, cfgm, pipeline=pipem)
    launchesm = read_launches()
    check_fused(launchesm, "M1")
    print(f"M1 {CODE} MS-{SCHEDULE} {MAX_ITER} it p={P_POINT}, 2 slots of "
          f"{pipem.per_dev}: launches {launchesm}")
    print(f"  counters {json.dumps(resm.counters)}; avg iterations X "
          f"{resm.avg_iterations_x!r} Z {resm.avg_iterations_z!r}")
    check(resm.counters == res.counters
          and resm.avg_iterations_x == res.avg_iterations_x
          and resm.avg_iterations_z == res.avg_iterations_z,
          "M1: the meshed counters equal phase 7's unmeshed counters")
    check(launchesm["channel"] == (SHOTS // BATCH) * 2,
          "M1: kernel A launched once per chunk and slot")
    check(launchesm["ms_qc MS"] > 0, "M1: kernel B (MS) launched")
    print(f"  warm {resm.warm_shots} shots in {resm.warm_time_s:.3f} s = "
          f"{resm.shots_per_s_warm:.1f} shots/s (phase 7, unmeshed: "
          f"{res.shots_per_s_warm:.1f})  [{smi}]")
    rm = simulate_p(Hx, Hz, P_POINT, dataclasses.replace(
        cfgm, shots=TIMED_SHOTS), pipeline=pipem)
    print(f"  timed run, 2 slots: {TIMED_SHOTS} shots, warm {rm.warm_shots} "
          f"shots in {rm.warm_time_s:.3f} s = {rm.shots_per_s_warm:.1f} "
          f"shots/s (phase 7's timed run, unmeshed: "
          f"{timed7.shots_per_s_warm:.1f}); qBLER {rm.qbler!r}  [{smi}]")
    check(rm.qbler == timed7.qbler, "M1: the timed run's qBLER is phase 7's")

    # M2. two processes sharing cuda:0, started as a launcher would
    phase("M2 two processes sharing cuda:0 (python3 -m qldpcsim_torch)")

    def free_port():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    def launch_env(rank, port):
        return dict(os.environ, PYTHONPATH=HERE, MASTER_ADDR="127.0.0.1",
                    MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(rank),
                    LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")

    def run_two(cmd, extra_env=None, timeout=RANK_TIMEOUT_S):
        """Two ranks of `cmd`; each must exit 0 within `timeout` seconds
        (every process is killed on the way out); their stdout."""
        port = free_port()
        procs = [subprocess.Popen(
            cmd, cwd=HERE, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            env=dict(launch_env(rank, port), **(extra_env or {})))
            for rank in range(2)]
        try:
            outs = [p_.communicate(timeout=timeout) for p_ in procs]
        finally:
            for p_ in procs:
                p_.kill()
                p_.wait()
        for rank, (p_, (_, err)) in enumerate(zip(procs, outs)):
            check(p_.returncode == 0, f"rank {rank} of {cmd[:4]}: rc "
                  f"{p_.returncode}\n{err[-3000:]}")
        return [o for o, _ in outs]

    def run_ranks(label, args):
        """`python3 -m qldpcsim_torch ARGS` on two ranks: rank 0's --out
        rows and each rank's kernel launches."""
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "out.jsonl")
            counts = os.path.join(tmp, "launches")
            t0 = time.perf_counter()
            stdout = run_two([sys.executable, "-m", "qldpcsim_torch", *args,
                              "--quiet", "--out", out],
                             {"QLDPC_LAUNCH_COUNTS": counts})
            secs = time.perf_counter() - t0
            with open(out) as f:
                rows = [json.loads(line) for line in f]
            per_rank = []
            for rank in range(2):
                with open(f"{counts}.{rank}") as f:
                    per_rank.append(json.load(f))
        check("SIMULATION RESULTS" in stdout[0] and stdout[1] == "",
              f"{label}: rank 0 alone prints the table")
        print(f"{label}: 2 ranks on cuda:0 in {secs:.1f} s (process start "
              f"included)")
        for rank, la in enumerate(per_rank):
            print(f"  rank {rank} launches "
                  f"{ {k: v for k, v in la.items() if v} }")
            check(la["channel"] > 0
                  and la["channel syndromes"] == la["channel"],
                  f"{label}: rank {rank} ran kernel A, one fused launch a "
                  "chunk")
        return rows, per_rank

    def rate(row):
        v = row["shots_per_s_warm"]
        return "not measured (one chunk)" if v is None else f"{v:.1f}"

    def same_counts(row, r):
        return ({k: row[k] for k in r.counters} == r.counters
                and row["Avg_number_of_iterations_X"] == r.avg_iterations_x
                and row["Avg_number_of_iterations_Z"] == r.avg_iterations_z)

    common = ["--batch", str(BATCH), "--rngSeed", str(SEED)]
    # (a) the flagship, shots sharded over the two ranks
    rows_a, la_a = run_ranks("M2a flagship --mesh", [
        "--code", CODE, "--p", str(P_POINT), "--shots", str(SHOTS),
        "--decType", "MS", "--decSchedule", SCHEDULE, "--decIterations",
        str(MAX_ITER), "--mesh", *common])
    check(same_counts(rows_a[0], res),
          "M2a: rank 0's counters equal phase 7's")
    for rank, la in enumerate(la_a):
        check(la["channel"] == SHOTS // BATCH and la["ms_qc MS"] > 0,
              f"M2a: rank {rank} ran kernels A (once a chunk) and B (MS)")
    print(f"  warm {rate(rows_a[0])} shots/s on rank 0 "
          f"(phase 7 in one process: {res.shots_per_s_warm:.1f})  [{smi}]")
    # (b) config 4's sweep with its p-points on two rows, one per rank
    rows_b, la_b = run_ranks("M2b config 4 --mesh-p 2", [
        "--Hx", files4[0], "--Hz", files4[1], "--p",
        *[str(v) for v in C4_P], "--shots", str(C4_SHOTS), "--decType",
        "MS", "--decSchedule", "S", "--decIterations", str(C4_ITER),
        "--rngSeed", str(SEED), "--mesh-p", "2"])
    check([r_["p"] for r_ in rows_b] == C4_P, "M2b: one row per p")
    for row, r4 in zip(rows_b, res4):
        check(same_counts(row, r4),
              f"M2b p={row['p']}: counters equal phase 13's serial sweep")
        print(f"  p={row['p']}: warm {rate(row)} shots/s "
              f"(phase 13: {r4.shots_per_s_warm:.1f})  [{smi}]")
    for rank, la in enumerate(la_b):
        check(la["channel"] == len(C4_P) // 2 * C4_SHOTS // BATCH
              and la["seq_qc MS"] > 0,
              f"M2b: rank {rank} ran kernels A (once a chunk of its two p) "
              "and D (MS)")
    # (c) config 5: BP + OSD-2, each rank with its own group-level OSD pass
    rows_c, la_c = run_ranks("M2c config 5 --mesh", [
        "--code", CODE, "--p", str(C5_P), "--shots", str(C5_SHOTS),
        "--decType", "BP", "--decSchedule", C5_SCHEDULE, "--decIterations",
        str(C5_ITER), "--OSDorder", str(C5_ORDER), "--mesh", *common])
    check(same_counts(rows_c[0], res5),
          "M2c: rank 0's counters equal phase 9's")
    for rank, la in enumerate(la_c):
        check(la["channel"] == C5_SHOTS // BATCH and la["ms_qc BP"] > 0
              and la["ms_qc MS"] == 0,
              f"M2c: rank {rank} ran kernels A and B (BP)")
    check(sum(la["gf2_elim"] for la in la_c) > 0,
          "M2c: kernel C launched by the ranks' OSD passes")
    print(f"  warm {rate(rows_c[0])} shots/s on rank 0 "
          f"(phase 9 in one process: {res5.shots_per_s_warm:.1f})  [{smi}]")
    # (d) the host time of one counter all-reduce between the two ranks
    stdout = run_two([sys.executable, "-c", ALLREDUCE_PROBE])
    probe = [json.loads(o.strip().splitlines()[-1]) for o in stdout]
    print(f"M2d counter all-reduce over gloo, 2 ranks, mean of "
          f"{probe[0]['reps']}: " + "; ".join(
              f"rank {i}: {pr['us_9']:.1f} us for 9 counters, "
              f"{pr['us_rows']:.1f} us for 2 x 9" for i, pr in
              enumerate(probe)) + f"  [{smi}]")
    print(f"mesh phases M1-M2: {time.perf_counter() - t_mesh:.1f} s")
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
        row("flood_qc_decode", "flood_qc.cu", "flood_qc_pallas.py:53",
            launches_cli_ms["flood_qc MS"], worst_f["MS"], f_times["MS"][0],
            f_times["MS"][1], f_times["MS"][4]),
        row("flood_qc_decode_bp", "flood_qc.cu", "flood_qc_pallas.py:53",
            launches_cli["flood_qc BP"], worst_f["BP"], f_times["BP"][0],
            f_times["BP"][1], f_times["BP"][4]),
        row("ms_qc_decode_bf16", "ms_qc.cu", "ms_qc_pallas.py:119",
            runs["flagship bf16"][2]["B bf16"]["MS"], worst_bf["MS"],
            bf_b["MS"][0], bf_b["MS"][1], bf_b["MS"][4]),
        row("ms_qc_decode_bp_bf16", "ms_qc.cu", "ms_qc_pallas.py:119",
            runs["config 5 bf16"][2]["B bf16"]["BP"], worst_bf["BP"],
            bf_b["BP"][0], bf_b["BP"][1], bf_b["BP"][4]),
        row("flood_qc_decode_bf16", "flood_qc.cu", "flood_qc_pallas.py:55",
            runs["MS-F bf16 F"][2]["F bf16"]["MS"], worst_bff["MS"],
            bf_f["MS"][0], bf_f["MS"][1], bf_f["MS"][4]),
        row("flood_qc_decode_bp_bf16", "flood_qc.cu", "flood_qc_pallas.py:55",
            runs["config 5 bf16 F"][2]["F bf16"]["BP"], worst_bff["BP"],
            bf_f["BP"][0], bf_f["BP"][1], bf_f["BP"][4]),
        row("ms_qc_decode_vec", "ms_qc.cu", "ms_qc_pallas.py:249",
            runs["flagship vec"][2]["B vec"], worst_vec, vec_b[SCHEDULE][0],
            vec_b[SCHEDULE][1], vec_b[SCHEDULE][4]),
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
