"""Monte-Carlo qBLER engine (port of `qldpcsim_tpu/engine/montecarlo.py`).

Per p-point: per-tile threefry keys -> depolarizing channel and syndromes ->
X and Z decodes (the straggler cascade around the QC min-sum decoder) ->
classification counters, summed over chunks. The key chain is the
reference's (seed -> p-index -> global tile, 64-shot tiles), so a run's
counters equal the reference's on its threefry path, and do not depend on
the device or the batch size.

On `device="cuda"` the channel and the decoder run as the CUDA kernels of
`ops/`; on `device="cpu"` their plain PyTorch versions run. A CUDA device
without a card raises; nothing falls back.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

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
from qldpcsim_torch.engine.classify import ClassifierStatic, classify_batch
from qldpcsim_torch.engine.results import PPointResult
from qldpcsim_torch.parallel.keys import chunk_keys
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


@dataclasses.dataclass
class SimConfig:
    """Simulation configuration: the reference's flag surface, and the
    device the pipeline runs on."""

    shots: int = 1000
    dec_type: str = "MS"
    dec_iterations: int = 99
    dec_schedule: str = "F"
    osd_order: int = -1
    rng_seed: Optional[int] = None
    batch_size: int = 0           # 0 = auto
    layer_compat: bool = False    # reproduce the reference's cross-wired
                                  # layers
    validate_encoding: bool = False
    checkpoint_dir: Optional[str] = None
    progress: bool = False
    impl: str = "auto"            # decoder implementation: auto | qc
    device: str = "cuda"          # "cuda" (the kernels) | "cpu" (their plain
                                  # PyTorch versions)

    def decoder_config(self) -> DecoderConfig:
        return DecoderConfig(
            dec_type=self.dec_type,
            max_iter=self.dec_iterations,
            schedule=self.dec_schedule,
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
    across p."""

    def __init__(self, Hx: np.ndarray, Hz: np.ndarray, cfg: SimConfig):
        super().__init__()
        if cfg.osd_order >= 0:
            raise NotImplementedError(
                "OSD comes with the config-5 slice (ROADMAP queue 1, "
                "'Config 5')")
        if cfg.validate_encoding:
            raise NotImplementedError(
                "validate_encoding comes with the user-surface slice "
                "(ROADMAP queue 1, 'User surfaces')")
        if cfg.checkpoint_dir:
            raise NotImplementedError(
                "checkpoints (utils/checkpoint.py) are not ported yet "
                "(ROADMAP queue 1)")
        self.device = _resolve_device(cfg.device)
        self.Hx = (np.asarray(Hx) % 2).astype(np.int8)
        self.Hz = (np.asarray(Hz) % 2).astype(np.int8)
        self.cfg = cfg
        self.n = self.Hx.shape[1]
        dcfg = cfg.decoder_config()
        self.dcfg = dcfg

        # X errors are decoded through Hz, Z errors through Hx.
        sched = dcfg.schedule.upper()
        layers_x = build_layers(self.Hz, sched,
                                H_layerize=self.Hx if cfg.layer_compat else None)
        layers_z = build_layers(self.Hx, sched,
                                H_layerize=self.Hz if cfg.layer_compat else None)
        self.dec_x = make_decoder(TannerGraph.build(self.Hz), dcfg,
                                  layers=layers_x, device=self.device)
        self.dec_z = make_decoder(TannerGraph.build(self.Hx), dcfg,
                                  layers=layers_z, device=self.device)
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
        """One chunk: sample, decode both sides, classify -> 0-d counters.
        tile_keys: (tiles_per_chunk, 2) int64, one key per global tile."""
        err_x, err_z, sy_z, sy_x = self._sample_chunk(tile_keys, p)
        valid = torch.arange(err_x.shape[0], device=self.device) < n_valid
        # the reference's prior p/3 (float32, as the reference's jitted
        # `p / 3.0` on a float32 p)
        prior = np.float32(p) / np.float32(3.0)
        res_x = self.dec_x(sy_z, prior)
        res_z = self.dec_z(sy_x, prior)
        return self._count(err_x, err_z, res_x.e_hat, res_z.e_hat, sy_z,
                           sy_x, res_x.n_iter, res_z.n_iter, valid)

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

    t0 = time.perf_counter()
    t_first = None  # set after the first chunk (kernel builds land there)
    warm_shots = 0
    totals = {k: 0 for k in _COUNTER_KEYS}
    acc = None      # device-side sums of the warm chunks
    for c0 in range(0, n_chunks, _KEY_GROUP_CHUNKS):
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
            acc = counts if acc is None else {
                k: acc[k] + counts[k] for k in acc}
            warm_shots += sum(n_valids)
        if cfg.progress:
            print(f"\r(p={p:5.2e}) decoded {min((c0 + g) * batch, shots)}"
                  f"/{shots} shots", end="", flush=True)
    if acc is not None:
        for k in _COUNTER_KEYS:
            totals[k] += int(acc[k])  # waits for the device
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
