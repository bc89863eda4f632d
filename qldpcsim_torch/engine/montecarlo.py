"""Monte-Carlo qBLER engine (port of `qldpcsim_tpu/engine/montecarlo.py`).

`simulate` is the p-sweep with the reference simulator's signature: one
`ShotPipeline` for the code and decoder, then `simulate_p` per p-point.
Per p-point: per-tile threefry keys -> depolarizing channel and syndromes ->
X and Z decodes (`decoders.make_decoder`: MS or BP over any H, in the
straggler cascade when the budget is deep; BF; NG) -> OSD over each side's
decoder-failed shots, when enabled (MS and BP) -> classification counters,
summed over chunks. The key chain is the reference's (seed ->
p-index -> global tile, 64-shot tiles), so a run's counters equal the
reference's on its threefry path, and do not depend on the device or the
batch size.

On `device="cuda"` the channel, the decoder and OSD's elimination run as
the CUDA kernels of `ops/`; on `device="cpu"` their plain PyTorch versions
run. A CUDA device without a card raises; nothing falls back.

With `checkpoint_dir` the counters are saved after every key group under an
id that pins everything the counter stream depends on, and a rerun resumes
at the first chunk not yet counted.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from qldpcsim_torch.channel.depolarizing import sample_shot_tiles
from qldpcsim_torch.decoders import (
    DecoderConfig,
    TannerGraph,
    build_layers,
    make_decoder,
)
from qldpcsim_torch.decoders.osd import OSD
from qldpcsim_torch.engine.classify import ClassifierStatic, classify_batch
from qldpcsim_torch.engine.results import PPointResult, format_results_table
from qldpcsim_torch.parallel.keys import chunk_keys
from qldpcsim_torch.utils.checkpoint import CheckpointStore
from qldpcsim_torch.utils.threefry import fold_in, prng_key

_COUNTER_KEYS = (
    "decSuccessExact",
    "decSuccessDegen",
    "DecFailures_X",
    "DecFailures_Z",
    "successStabilizer",
    "logicalErrors_X",
    "logicalErrors_Z",
    "nIterAccX",
    "nIterAccZ",
)

# Chunks whose tile keys are derived in one pass (bounds the key buffer).
_KEY_GROUP_CHUNKS = 128

# Shots per OSD call (the reference's window cap, min(batch, 256)).
_OSD_WINDOW = 256


@dataclasses.dataclass
class SimConfig:
    """Simulation configuration: the reference's flag surface, and the
    device the pipeline runs on."""

    shots: int = 1000
    dec_type: str = "MS"
    dec_iterations: int = 99
    dec_schedule: str = "F"
    osd_order: int = -1           # OSD post-decoder order (MS, BP); -1 off
    eps: float = 1e-6             # BP tanh clamp (DecoderConfig.eps)
    rng_seed: Optional[int] = None
    batch_size: int = 0           # 0 = auto
    layer_compat: bool = False    # reproduce the reference's cross-wired
                                  # layers
    bf_residual: str = "mod2"     # BF residual: "mod2" | "bool" (the
                                  # reference simulator's; decoders/bf.py)
    validate_encoding: bool = False
    checkpoint_dir: Optional[str] = None
    progress: bool = False
    impl: str = "auto"            # decoder implementation override
                                  # (DecoderConfig.impl):
                                  # auto | edge | mxu | seq | qc | gh
    device: str = "cuda"          # "cuda" (the kernels) | "cpu" (their plain
                                  # PyTorch versions)

    def decoder_config(self) -> DecoderConfig:
        return DecoderConfig(
            dec_type=self.dec_type,
            max_iter=self.dec_iterations,
            schedule=self.dec_schedule,
            eps=self.eps,
            bf_residual=self.bf_residual,
            impl=self.impl,
        )


def _auto_batch(n: int, shots: int) -> int:
    """Chunk size: 4096 shots (2048 for n > 1536), fewer when the run is
    shorter, always a multiple of the 64-shot RNG tile."""
    target = 4096 if n <= 1536 else 2048
    b = min(target, max(64, shots))
    return max(64, (b // 64) * 64)


def _tile_size(batch: int) -> int:
    """RNG tile size: 64 when the batch allows (the layout-invariant tile),
    else the largest divisor of both."""
    return max(1, math.gcd(batch, 64))


def _resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("SimConfig(device='cuda') but torch sees no CUDA "
                           "device; use device='cpu' for the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    return dev


class ShotPipeline(nn.Module):
    """Per-(code, decoder-config) shot pipeline on one device, reusable
    across p: the X and Z decoders (MS, BP, BF or NG), OSD over each side's
    decoder-failed shots when `cfg.osd_order >= 0` (MS and BP only, as the
    reference: BF and NG give no posterior), and the classifier.
    `osd_shots` counts the shots each side sent to OSD."""

    def __init__(self, Hx: np.ndarray, Hz: np.ndarray, cfg: SimConfig):
        super().__init__()
        if cfg.validate_encoding:
            raise NotImplementedError(
                "validate_encoding comes with the user-surface slice "
                "(ROADMAP queue 1, 'User surfaces')")
        self.device = _resolve_device(cfg.device)
        self.Hx = (np.asarray(Hx) % 2).astype(np.int8)
        self.Hz = (np.asarray(Hz) % 2).astype(np.int8)
        self.cfg = cfg
        self.n = self.Hx.shape[1]
        dcfg = cfg.decoder_config()
        self.dcfg = dcfg

        # X errors are decoded through Hz, Z errors through Hx. BF and NG
        # have no schedule.
        layers_x = layers_z = None
        if dcfg.dec_type.upper() in ("MS", "BP"):
            sched = dcfg.schedule.upper()
            layers_x = build_layers(
                self.Hz, sched,
                H_layerize=self.Hx if cfg.layer_compat else None)
            layers_z = build_layers(
                self.Hx, sched,
                H_layerize=self.Hz if cfg.layer_compat else None)
        self.dec_x = make_decoder(TannerGraph.build(self.Hz), dcfg,
                                  layers=layers_x, device=self.device)
        self.dec_z = make_decoder(TannerGraph.build(self.Hx), dcfg,
                                  layers=layers_z, device=self.device)
        self.use_osd = (cfg.osd_order >= 0
                        and dcfg.dec_type.upper() in ("MS", "BP"))
        if self.use_osd:
            self.osd_x = OSD(self.Hz, cfg.osd_order, device=self.device)
            self.osd_z = OSD(self.Hx, cfg.osd_order, device=self.device)
        self.osd_shots = {"x": 0, "z": 0}
        self.classifier = ClassifierStatic.build(self.Hx, self.Hz,
                                                 device=self.device)
        for name, H in (("Hx_T", self.Hx), ("Hz_T", self.Hz)):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(H.T), dtype=torch.float32,
                device=self.device))

        self.batch = cfg.batch_size or _auto_batch(self.n, cfg.shots)
        self.tile = _tile_size(self.batch)
        self.tiles_per_chunk = self.batch // self.tile

    def _sample_chunk(self, tile_keys: torch.Tensor, p):
        return sample_shot_tiles(tile_keys, p, self.n, self.tile, self.Hx_T,
                                 self.Hz_T)

    def _chunk_body(self, tile_keys: torch.Tensor, p, n_valid: int
                    ) -> Dict[str, torch.Tensor]:
        """One chunk: sample, decode both sides [+ OSD], classify -> 0-d
        counters. tile_keys: (tiles_per_chunk, 2) int64, one key per global
        tile."""
        err_x, err_z, sy_z, sy_x = self._sample_chunk(tile_keys, p)
        valid = torch.arange(err_x.shape[0], device=self.device) < n_valid
        ex_hat, ez_hat, it_x, it_z = self._decode(sy_z, sy_x, p, valid)
        return self._count(err_x, err_z, ex_hat, ez_hat, sy_z, sy_x, it_x,
                           it_z, valid)

    def _decode(self, sy_z, sy_x, p, valid):
        """Both sides' decodes, then OSD over each side's decoder-failed
        valid shots -> (ex_hat, ez_hat, n_iter_x, n_iter_z)."""
        # the reference's prior p/3 (float32, as the reference's jitted
        # `p / 3.0` on a float32 p)
        prior = np.float32(p) / np.float32(3.0)
        res_x = self.dec_x(sy_z, prior)
        res_z = self.dec_z(sy_x, prior)
        ex_hat, ez_hat = res_x.e_hat, res_z.e_hat
        if self.use_osd:
            ex_hat = self._apply_osd(self.osd_x, ex_hat, res_x.posterior,
                                     sy_z, ~res_x.converged & valid)
            ez_hat = self._apply_osd(self.osd_z, ez_hat, res_z.posterior,
                                     sy_x, ~res_z.converged & valid)
        return ex_hat, ez_hat, res_x.n_iter, res_z.n_iter

    def _apply_osd(self, osd: OSD, e_hat, post, syn, failed):
        """`osd` over the `failed` shots of a batch, in windows of at most
        256 shots taken in lane-ascending order (the reference's in-chunk
        `_apply_osd`). OSD acts shot by shot, so the windows do not change
        the result, and the counters equal the reference's in-chunk and
        deferred paths alike. `torch.nonzero` costs one host sync per side
        per chunk: the window count."""
        order = torch.nonzero(failed).flatten()
        n_failed = int(order.numel())
        self.osd_shots["x" if osd is self.osd_x else "z"] += n_failed
        if n_failed == 0:
            return e_hat
        cap = min(e_hat.shape[0], _OSD_WINDOW)
        out = e_hat.clone()
        for lo in range(0, n_failed, cap):
            idx = order[lo:lo + cap]
            out[idx] = osd(e_hat[idx], syn[idx], post[idx])
        return out

    def _multi_chunk_body(self, keys: torch.Tensor, p, n_valids
                          ) -> Dict[str, torch.Tensor]:
        """Chunks keys[0], keys[1], ... ((g, tiles, 2)) with n_valids[i]
        valid shots each; counters summed on the device."""
        total = None
        for k, nv in zip(keys, n_valids):
            counts = self._chunk_body(k, p, int(nv))
            total = counts if total is None else {
                name: total[name] + counts[name] for name in total}
        return total

    def _count(self, err_x, err_z, ex_hat, ez_hat, sy_z, sy_x, it_x, it_z,
               valid) -> Dict[str, torch.Tensor]:
        counts = classify_batch(self.classifier, err_x, err_z, ex_hat, ez_hat,
                                sy_z, sy_x, valid=valid)
        zero = torch.zeros((), dtype=it_x.dtype, device=it_x.device)
        counts["nIterAccX"] = torch.where(valid, it_x, zero).sum()
        counts["nIterAccZ"] = torch.where(valid, it_z, zero).sum()
        return counts


def _ckpt_id(pipe: ShotPipeline, cfg: SimConfig, seed: int, p: float,
             p_index: int) -> str:
    """Checkpoint identity digest: everything that determines the counter
    stream and its chunk layout. The code itself (Hx/Hz bytes), the fully
    resolved decoder config, the OSD order, layer_compat, the chunk layout
    (batch and RNG tile size: `chunks_done` only means something under the
    layout that wrote it), shots, seed, p and the p-index. A resume after a
    change to any of these misses the old checkpoint instead of reusing
    stale counts. The device is not part of it: counters do not depend on
    it for MS, and for BP differ only as two runs of a Monte-Carlo estimate
    do."""
    payload = {
        "Hx_shape": list(pipe.Hx.shape), "Hz_shape": list(pipe.Hz.shape),
        "Hx": hashlib.sha256(pipe.Hx.tobytes()).hexdigest(),
        "Hz": hashlib.sha256(pipe.Hz.tobytes()).hexdigest(),
        "dcfg": dataclasses.asdict(pipe.dcfg),
        "osd_order": int(cfg.osd_order),
        "layer_compat": bool(cfg.layer_compat),
        "batch": pipe.batch, "tile": pipe.tile,
        "shots": cfg.shots, "seed": int(seed),
        "p": f"{p:.17e}", "p_index": int(p_index),
    }
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


def simulate_p(Hx: np.ndarray, Hz: np.ndarray, p: float,
               cfg: Optional[SimConfig] = None,
               pipeline: Optional[ShotPipeline] = None,
               p_index: int = 0) -> PPointResult:
    """Monte-Carlo qBLER estimate at one depolarization probability."""
    cfg = cfg or SimConfig()
    pipe = pipeline or ShotPipeline(Hx, Hz, cfg)
    shots = cfg.shots
    batch = pipe.batch
    n_chunks = -(-shots // batch)
    tpc = pipe.tiles_per_chunk
    seed = cfg.rng_seed if cfg.rng_seed is not None else 0
    key = fold_in(prng_key(seed, device=pipe.device), p_index)

    store = CheckpointStore(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    ckpt_id = (f"p{p_index}_{cfg.dec_type}{cfg.dec_schedule}_"
               + _ckpt_id(pipe, cfg, seed, p, p_index))
    totals = {k: 0 for k in _COUNTER_KEYS}
    start_chunk = 0
    if store is not None:
        saved = store.load(ckpt_id)
        if saved is not None:
            totals, start_chunk = saved

    t0 = time.perf_counter()
    t_first = None  # set after the first chunk (kernel builds land there)
    warm_shots = 0
    for c0 in range(start_chunk, n_chunks, _KEY_GROUP_CHUNKS):
        g = min(_KEY_GROUP_CHUNKS, n_chunks - c0)
        # global tile stream: chunk c owns tiles [c * tpc, (c + 1) * tpc)
        keys = chunk_keys(key, c0 * tpc, g * tpc).reshape(g, tpc, 2)
        n_valids = [min(batch, shots - c * batch) for c in range(c0, c0 + g)]
        if t_first is None:
            counts = pipe._chunk_body(keys[0], p, n_valids[0])
            for k in _COUNTER_KEYS:
                totals[k] += int(counts[k])  # waits for the device
            t_first = time.perf_counter()
            keys, n_valids = keys[1:], n_valids[1:]
        if n_valids:
            counts = pipe._multi_chunk_body(keys, p, n_valids)
            for k in _COUNTER_KEYS:
                totals[k] += int(counts[k])  # waits for the device
            warm_shots += sum(n_valids)
        if store is not None:
            store.save(ckpt_id, totals, c0 + g)
        if cfg.progress:
            print(f"\r(p={p:5.2e}) decoded {min((c0 + g) * batch, shots)}"
                  f"/{shots} shots", end="", flush=True)
    t_end = time.perf_counter()
    if cfg.progress:
        print()
    warm_elapsed = ((t_end - t_first) if (t_first is not None and warm_shots)
                    else float("nan"))
    return PPointResult(
        p=float(p),
        shots=shots,
        counters={k: totals[k] for k in _COUNTER_KEYS
                  if not k.startswith("nIter")},
        avg_iterations_x=totals["nIterAccX"] / float(shots),
        avg_iterations_z=totals["nIterAccZ"] / float(shots),
        wall_time_s=t_end - t0,
        warm_time_s=warm_elapsed,
        warm_shots=warm_shots,
    )


def simulate(HxFile: str, HzFile: str, p: Sequence[float],
             shots: int = 1000, decType: str = "MS", decIterations: int = 99,
             decSchedule: str = "F", OSDorder: int = -1,
             rngSeed: Optional[int] = None, **kwargs) -> List[PPointResult]:
    """p-sweep with the reference simulator's signature and results table
    (the reference's `simulate`): one pipeline, the p-points one after
    another, each on its own key branch `p_index` = position in `p`.
    `kwargs` are further `SimConfig` fields; `device` defaults to "cuda"."""
    from qldpcsim_torch.codes.loader import load_matrix

    Hx = load_matrix(HxFile)
    Hz = load_matrix(HzFile)
    p = np.asarray(p, dtype=np.float64)
    if p.size == 0 or p.max() > 1.0 or p.min() < 0.0:
        raise ValueError("p must be a non-empty sequence of probabilities "
                         "in [0, 1]")
    cfg = SimConfig(shots=shots, dec_type=decType,
                    dec_iterations=decIterations, dec_schedule=decSchedule,
                    osd_order=OSDorder, rng_seed=rngSeed, **kwargs)
    pipe = ShotPipeline(Hx, Hz, cfg)
    results = [simulate_p(Hx, Hz, pT, cfg, pipeline=pipe, p_index=i)
               for i, pT in enumerate(p)]
    print(format_results_table(results))
    return results
