"""Monte-Carlo qBLER engine (port of `qldpcsim_tpu/engine/montecarlo.py`).

`simulate` is the p-sweep with the reference simulator's signature: one
`ShotPipeline` for the code and decoder, then `simulate_p` per p-point.
Per p-point: per-tile threefry keys -> depolarizing channel and syndromes ->
X and Z decodes (`decoders.make_decoder`: MS or BP over any H, in the
straggler cascade when the budget is deep; BF; NG) -> OSD over each side's
decoder-failed shots, when enabled (MS and BP) -> classification counters,
summed over chunks. Within a key group the chunks hand their decoder-failed
shots to one group-level OSD pass (`_chunk_body_defer`,
`_osd_group_finish`), which fills OSD's windows where a chunk alone leaves
them nearly empty; OSD acts shot by shot, so the counters are those of the
in-chunk path. With `validate_encoding` every chunk runs the full encode ->
corrupt -> extract pipeline on random codeword frames (`channel/encoder.py`),
which leaves every counter as it is. The key chain is the reference's (seed ->
p-index -> global tile, 64-shot tiles), so a run's counters equal the
reference's on its threefry path, and do not depend on the device or the
batch size.

On `device="cuda"` the channel, the decoder and OSD's elimination run as
the CUDA kernels of `ops/`; on `device="cpu"` their plain PyTorch versions
run. A CUDA device without a card raises; nothing falls back.

With `cfg.mesh` (`parallel.mesh.make_mesh`) the chunks are split over
slots: chunk c owns global tiles [c tpc, (c + 1) tpc), and slot d of the
chunk the d-th run of `tiles_per_dev` of them, so the counters are those of
the unmeshed run whenever the 64-shot tile fits the layout. Each local slot
has its own `ShotPipeline` on its own device, driven by its own host thread;
the counters are summed once per key group over the slots and the processes.
`simulate_sweep` lays the p-points of a sweep over a second axis of slots.

With `checkpoint_dir` the counters are saved after every key group under an
id that pins everything the counter stream depends on, and a rerun resumes
at the first chunk not yet counted. Under several processes every rank
reads the checkpoint and rank 0 writes it, after the reduction.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from qldpcsim_torch.channel.depolarizing import (
    sample_shot_tiles,
    syndromes_of,
)
from qldpcsim_torch.channel.encoder import CSSEncoder
from qldpcsim_torch.decoders import (
    DecoderConfig,
    TannerGraph,
    build_layers,
    make_decoder,
)
from qldpcsim_torch.decoders.osd import OSD
from qldpcsim_torch.engine import group_cascade
from qldpcsim_torch.engine.classify import ClassifierStatic, classify_batch
from qldpcsim_torch.engine.results import PPointResult, format_results_table
from qldpcsim_torch.ops import _build
from qldpcsim_torch.ops.channel_cuda import SyndromeTables, sample_tiles
from qldpcsim_torch.parallel.keys import chunk_keys
from qldpcsim_torch.parallel.mesh import (
    Mesh,
    local_mesh_rows,
    make_mesh,
    per_device_multi_chunk_fn,
    world,
)
from qldpcsim_torch.utils.checkpoint import CheckpointStore
from qldpcsim_torch.utils.profiling import span
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

# Decoder-failed shots waiting for the group-level OSD pass: the pass runs
# whenever this many records are pending, and at the end of the key group. A
# record holds both errors and both estimates (1 byte per qubit each), both
# syndromes and both posteriors (float32) and two flags: 12 n + 4 (mx + mz)
# + 2 bytes, 8,450 on lp118_0 (n 544, 240 checks per side), so at most
# ~69 MB wait there (~135 MB on the Tanner code), however many of a key
# group's 524,288 shots fail.
_OSD_PENDING_MAX = 8192

# Frame key of a chunk under validate_encoding: fold_in(tile_keys[0], 'ENC').
_ENC_FOLD = 0x454E43


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
                                  # PyTorch versions); with a mesh, the
                                  # slots' devices are the mesh's
    mesh: Optional[Mesh] = None   # parallel.mesh.make_mesh(): shard each
                                  # chunk's shots over the slots
    mesh_p: int = 0               # > 0: `simulate` lays the p-points over
                                  # mesh_p rows of slots (simulate_sweep)
    exec_mode: str = "auto"       # sharded execution: "auto" | "perdevice"
                                  # (the one mode: a host thread per local
                                  # slot, counters summed on the host and
                                  # over processes); env QLDPC_EXEC_MODE
    sort_window: int = -1         # accepted and ignored: the reference's
                                  # shot ordering evens out its 128-lane
                                  # blocks, and the kernels here run a
                                  # block per shot

    def decoder_config(self) -> DecoderConfig:
        return DecoderConfig(
            dec_type=self.dec_type,
            max_iter=self.dec_iterations,
            schedule=self.dec_schedule,
            eps=self.eps,
            bf_residual=self.bf_residual,
            impl=self.impl,
        )


def _auto_batch(n: int, shots: int, n_dev: int = 1) -> int:
    """Chunk size: 4096 shots (2048 for n > 1536), fewer when the run is
    shorter, always a multiple of 64 * n_dev, so that every slot's share is
    whole 64-shot RNG tiles and the counters do not depend on the layout."""
    quantum = 64 * n_dev
    target = 4096 if n <= 1536 else 2048
    b = min(max(target, quantum), max(quantum, shots))
    return max(quantum, (b // quantum) * quantum)


def _tile_size(batch: int, per_dev: Optional[int] = None) -> int:
    """RNG tile size: 64 when the layout allows (the layout-invariant tile),
    else the largest divisor of the batch and of a slot's share."""
    t = math.gcd(batch, 64)
    if per_dev is not None and per_dev % t:
        t = math.gcd(per_dev, t)
    return max(1, t)


def _resolve_exec_mode(cfg: SimConfig) -> str:
    """The sharded execution mode: `cfg.exec_mode`, or `QLDPC_EXEC_MODE`
    when that is "auto". The port has one mode, "perdevice"; the
    reference's "shardmap" (one partitioned program) has no counterpart."""
    mode = cfg.exec_mode
    if mode == "auto":
        mode = os.environ.get("QLDPC_EXEC_MODE", "auto")
    if mode == "auto":
        mode = "perdevice"
    if mode != "perdevice":
        raise ValueError(f"exec_mode must be 'auto' or 'perdevice' (the one "
                         f"sharded mode of this package), got {mode!r}")
    return mode


def default_mesh(device: str, rows: int = 1) -> Mesh:
    """The mesh a run takes when it is given none: the cards this process
    owns (`make_mesh()`), or, on the CPU, enough CPU slots per process that
    the slots of all processes fill `rows` p-rows evenly."""
    if torch.device(device).type == "cuda":
        return make_mesh()
    n_proc = world()[1]
    return make_mesh(["cpu"] * (rows // math.gcd(rows, n_proc)))


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
    `osd_shots` counts the shots each side sent to OSD, `osd_syncs` the
    host syncs of the OSD path (one per `torch.nonzero`). With
    `QLDPC_GROUP_CASCADE=1` in the environment when it is built (MS and BP
    with a cascade) its key groups run the group-deferred cascade
    (`engine/group_cascade.py`, `self.group_cascade`), which changes no
    counter.

    With `cfg.mesh` the pipeline is the layout of a sharded run: a chunk of
    `batch` shots is `n_dev` slots of `per_dev` shots (`tiles_per_dev`
    tiles), the slots of `rows` p-rows share the mesh, and `slots` holds one
    pipeline per local slot, on its device, with `batch = per_dev`.

    `chunk_at` is [p_index, chunk] of the next chunk a body call runs, the
    arguments of its `qldpc.chunk` span (`locate` sets it, the multi-chunk
    bodies advance it)."""

    def __init__(self, Hx: np.ndarray, Hz: np.ndarray, cfg: SimConfig,
                 rows: int = 1):
        super().__init__()
        self.Hx = (np.asarray(Hx) % 2).astype(np.int8)
        self.Hz = (np.asarray(Hz) % 2).astype(np.int8)
        self.cfg = cfg
        self.n = self.Hx.shape[1]
        dcfg = cfg.decoder_config()
        self.dcfg = dcfg
        self.mesh = cfg.mesh
        n_dev = 1
        if self.mesh is not None:
            self.exec_mode = _resolve_exec_mode(cfg)
            if self.mesh.size % rows:
                raise ValueError(f"mesh_p={rows} must divide the slot count "
                                 f"{self.mesh.size}")
            n_dev = self.mesh.size // rows
        self.batch = cfg.batch_size or _auto_batch(self.n, cfg.shots, n_dev)
        if self.batch % n_dev:
            raise ValueError(f"batch_size {self.batch} not divisible by the "
                             f"slot count {n_dev}")
        self.n_dev = n_dev
        self.per_dev = self.batch // n_dev
        self.tile = _tile_size(self.batch, self.per_dev)
        self.tiles_per_dev = self.per_dev // self.tile
        self.tiles_per_chunk = self.batch // self.tile
        self.group_cascade = None
        self.chunk_at = [0, 0]
        if self.mesh is not None:
            if (self.mesh.world_size > 1
                    and any(d.type == "cuda" for d in self.mesh.devices)):
                _build.load_all()  # rank 0 builds, the other ranks wait
            slot_cfg = dataclasses.replace(cfg, mesh=None, mesh_p=0,
                                           batch_size=self.per_dev)
            self.slots = nn.ModuleList([
                ShotPipeline(Hx, Hz, dataclasses.replace(slot_cfg,
                                                         device=str(d)))
                for d in self.mesh.devices])
            self.device = self.slots[0].device
            self.run_slots = per_device_multi_chunk_fn(
                self.mesh, [s._multi_chunk_body for s in self.slots],
                _COUNTER_KEYS, rows=rows)
            return
        self.slots = None
        self.device = _resolve_device(cfg.device)

        # X errors are decoded through Hz, Z errors through Hx. BF and NG
        # have no schedule. The group cascade builds its decoders from the
        # same graphs and layers.
        self.layers_x = self.layers_z = None
        if dcfg.dec_type.upper() in ("MS", "BP"):
            sched = dcfg.schedule.upper()
            self.layers_x = build_layers(
                self.Hz, sched,
                H_layerize=self.Hx if cfg.layer_compat else None)
            self.layers_z = build_layers(
                self.Hx, sched,
                H_layerize=self.Hz if cfg.layer_compat else None)
        self.graph_x = TannerGraph.build(self.Hz)
        self.graph_z = TannerGraph.build(self.Hx)
        self.dec_x = make_decoder(self.graph_x, dcfg, layers=self.layers_x,
                                  device=self.device)
        self.dec_z = make_decoder(self.graph_z, dcfg, layers=self.layers_z,
                                  device=self.device)
        self.use_osd = (cfg.osd_order >= 0
                        and dcfg.dec_type.upper() in ("MS", "BP"))
        if self.use_osd:
            self.osd_x = OSD(self.Hz, cfg.osd_order, device=self.device)
            self.osd_z = OSD(self.Hx, cfg.osd_order, device=self.device)
        self.osd_shots = {"x": 0, "z": 0}
        self.osd_syncs = 0
        # read once, here: the gate is no counter, so no checkpoint id
        if group_cascade.enabled(dcfg):
            self.group_cascade = group_cascade.GroupCascade(self)
        self.encoder = (CSSEncoder.build(self.Hx, self.Hz)
                        if cfg.validate_encoding else None)
        self.classifier = ClassifierStatic.build(self.Hx, self.Hz,
                                                 device=self.device)
        # the channel's syndromes: kernel A forms them from CSR tables of
        # both matrices; the encoder's framed words go through the float32
        # products of `syndromes_of`
        self.syn_tabs = SyndromeTables.build(self.Hx, self.Hz,
                                             device=self.device)
        if self.encoder is not None:
            for name, H in (("Hx_T", self.Hx), ("Hz_T", self.Hz)):
                self.register_buffer(name, torch.as_tensor(
                    np.ascontiguousarray(H.T), dtype=torch.float32,
                    device=self.device))

    def _sample_chunk(self, tile_keys: torch.Tensor, p):
        """Channel sampling for one chunk. With `cfg.validate_encoding` the
        full pipeline runs: encode a random codeword frame, corrupt it with
        the channel's error, extract the syndromes from the corrupted
        codeword, and recover the effective error as word XOR frame. Both
        check matrices annihilate a frame, so syndromes, effective errors
        and every counter equal the frame-free channel's. Without the
        encoder the syndromes come from the channel's own launch; with it
        the channel draws the errors alone, and the syndromes are formed
        once, from the corrupted words."""
        with span("qldpc.channel"):
            if self.encoder is None:
                return sample_shot_tiles(tile_keys, p, self.n, self.tile,
                                         self.syn_tabs)
            err_x, err_z = sample_tiles(tile_keys, p, self.n, self.tile)
            fx, fz = self.encoder.encode(fold_in(tile_keys[0], _ENC_FOLD),
                                         err_x.shape[0])
            fx, fz = fx.bool(), fz.bool()
            word_x, word_z = err_x.bool() ^ fx, err_z.bool() ^ fz
            sy_z, sy_x = syndromes_of(word_x, word_z, self.Hx_T, self.Hz_T)
            return ((word_x ^ fx).to(err_x.dtype),
                    (word_z ^ fz).to(err_z.dtype), sy_z, sy_x)

    def classify(self, err_x, err_z, ex_hat, ez_hat, sy_z, sy_x, valid
                 ) -> Dict[str, torch.Tensor]:
        """`classify_batch` with this pipeline's classifier: the one call
        every chunk, finish and group pass makes."""
        with span("qldpc.classify"):
            return classify_batch(self.classifier, err_x, err_z, ex_hat,
                                  ez_hat, sy_z, sy_x, valid=valid)

    def locate(self, p_indices: Sequence[int], chunk: int) -> None:
        """The next body call's first chunk is chunk `chunk` of the job on
        key branch `p_indices[r]` for p-row r (each local slot of a mesh by
        its row): the arguments of the chunks' spans."""
        if self.slots is None:
            self.chunk_at = [int(p_indices[0]), chunk]
            return
        per_row = self.mesh.size // len(p_indices)
        for (s, _), slot in zip(local_mesh_rows(self.mesh), self.slots):
            slot.chunk_at = [int(p_indices[s // per_row]), chunk]

    def _chunk_body(self, tile_keys: torch.Tensor, p, n_valid: int
                    ) -> Dict[str, torch.Tensor]:
        """One chunk: sample, decode both sides [+ OSD], classify -> 0-d
        counters. tile_keys: (tiles_per_chunk, 2) int64, one key per global
        tile. Self-contained (OSD finishes its failures in the chunk); the
        key groups of `_multi_chunk_body` use `_chunk_body_defer`."""
        with span("qldpc.chunk", p_index=self.chunk_at[0],
                  chunk=self.chunk_at[1]):
            err_x, err_z, sy_z, sy_x = self._sample_chunk(tile_keys, p)
            valid = torch.arange(err_x.shape[0], device=self.device) < n_valid
            ex_hat, ez_hat, it_x, it_z = self._decode(sy_z, sy_x, p, valid)
            return self._count(err_x, err_z, ex_hat, ez_hat, sy_z, sy_x,
                               it_x, it_z, valid)

    def _decode_sides(self, sy_z, sy_x, p):
        """The X and Z decodes of a chunk -> (DecodeResult, DecodeResult)."""
        # the reference's prior p/3 (float32, as the reference's jitted
        # `p / 3.0` on a float32 p)
        prior = np.float32(p) / np.float32(3.0)
        with span("qldpc.decode.x"):
            res_x = self.dec_x(sy_z, prior)
        with span("qldpc.decode.z"):
            res_z = self.dec_z(sy_x, prior)
        return res_x, res_z

    def _decode(self, sy_z, sy_x, p, valid):
        """Both sides' decodes, then OSD over each side's decoder-failed
        valid shots -> (ex_hat, ez_hat, n_iter_x, n_iter_z)."""
        res_x, res_z = self._decode_sides(sy_z, sy_x, p)
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
        deferred paths alike. `torch.nonzero` costs one host sync per call:
        the window count."""
        with span("qldpc.osd"):
            with span("qldpc.osd.compact"):
                order = torch.nonzero(failed).flatten()
                n_failed = int(order.numel())
            self.osd_syncs += 1
            self.osd_shots["x" if osd is self.osd_x else "z"] += n_failed
            if n_failed == 0:
                return e_hat
            cap = min(e_hat.shape[0], _OSD_WINDOW)
            out = e_hat.clone()
            for lo in range(0, n_failed, cap):
                idx = order[lo:lo + cap]
                out[idx] = osd(e_hat[idx], syn[idx], post[idx])
            return out

    def _chunk_body_defer(self, tile_keys: torch.Tensor, p, n_valid: int):
        """Chunk body of a key group with OSD: sample, decode, then
        `_defer`."""
        with span("qldpc.chunk", p_index=self.chunk_at[0],
                  chunk=self.chunk_at[1]):
            err_x, err_z, sy_z, sy_x = self._sample_chunk(tile_keys, p)
            valid = torch.arange(err_x.shape[0], device=self.device) < n_valid
            res_x, res_z = self._decode_sides(sy_z, sy_x, p)
            return self._defer(err_x, err_z, sy_z, sy_x, res_x, res_z, valid)

    def _defer(self, err_x, err_z, sy_z, sy_x, res_x, res_z, valid):
        """Count the shots that need no OSD (both sides converged) and the
        iterations of all valid shots, and return the counters with the
        records of the decoder-failed shots for the group-level pass (None
        when there are none). The `torch.nonzero` that compacts them is the
        chunk's one host sync for OSD."""
        with span("qldpc.osd.defer"):
            failed = ~(res_x.converged & res_z.converged) & valid
            counts = self.classify(err_x, err_z, res_x.e_hat, res_z.e_hat,
                                   sy_z, sy_x, valid=valid & ~failed)
            # OSD never touches n_iter: counted here for all valid shots
            self._count_iterations(counts, res_x.n_iter, res_z.n_iter, valid)
            idx = torch.nonzero(failed).flatten()
            self.osd_syncs += 1
            if idx.numel() == 0:
                return counts, None
            return counts, {
                "err_x": err_x[idx], "err_z": err_z[idx],
                "sy_z": sy_z[idx], "sy_x": sy_x[idx],
                "ex": res_x.e_hat[idx], "ez": res_z.e_hat[idx],
                "px": res_x.posterior[idx], "pz": res_z.posterior[idx],
                "cx": res_x.converged[idx], "cz": res_z.converged[idx]}

    def _osd_group_finish(self, pending: List[Dict[str, torch.Tensor]]
                          ) -> Dict[str, torch.Tensor]:
        """One OSD pass over the pending records of several chunks (the
        reference's `_osd_group_finish`): each side's unconverged records go
        through OSD in full windows, then one classification. Returns the
        event counters of these shots; their iterations were counted in
        their chunks."""
        with span("qldpc.osd.group"):
            rec = {name: torch.cat([d[name] for d in pending]) for name in
                   pending[0]}
            ex = self._apply_osd(self.osd_x, rec["ex"], rec["px"],
                                 rec["sy_z"], ~rec["cx"])
            ez = self._apply_osd(self.osd_z, rec["ez"], rec["pz"],
                                 rec["sy_x"], ~rec["cz"])
            counts = self.classify(rec["err_x"], rec["err_z"], ex, ez,
                                   rec["sy_z"], rec["sy_x"],
                                   valid=torch.ones_like(rec["cx"]))
            zero = torch.zeros((), dtype=torch.int32, device=self.device)
            counts["nIterAccX"] = counts["nIterAccZ"] = zero
            return counts

    def _multi_chunk_body(self, keys: torch.Tensor, p, n_valids
                          ) -> Dict[str, torch.Tensor]:
        """Chunks keys[0], keys[1], ... ((g, tiles, 2)) with n_valids[i]
        valid shots each; counters summed on the device. With OSD on, the
        chunks defer their decoder-failed shots to a group-level OSD pass,
        which runs when `_OSD_PENDING_MAX` records wait and at the end.
        Under the group cascade its chunks defer their stragglers instead,
        with the same flushes (`GroupCascade.multi_chunk_body`)."""
        if self.group_cascade is not None:
            return self.group_cascade.multi_chunk_body(keys, p, n_valids,
                                                       _OSD_PENDING_MAX)

        def add(total, counts):
            return counts if total is None else {
                name: total[name] + counts[name] for name in total}

        total = None
        if not self.use_osd:
            for k, nv in zip(keys, n_valids):
                total = add(total, self._chunk_body(k, p, int(nv)))
                self.chunk_at[1] += 1
            return total
        pending, n_pending = [], 0
        for k, nv in zip(keys, n_valids):
            counts, defer = self._chunk_body_defer(k, p, int(nv))
            self.chunk_at[1] += 1
            total = add(total, counts)
            if defer is not None:
                pending.append(defer)
                n_pending += defer["cx"].shape[0]
            if n_pending >= _OSD_PENDING_MAX:
                total = add(total, self._osd_group_finish(pending))
                pending, n_pending = [], 0
        if pending:
            total = add(total, self._osd_group_finish(pending))
        return total

    def _count(self, err_x, err_z, ex_hat, ez_hat, sy_z, sy_x, it_x, it_z,
               valid) -> Dict[str, torch.Tensor]:
        counts = self.classify(err_x, err_z, ex_hat, ez_hat, sy_z, sy_x,
                               valid=valid)
        self._count_iterations(counts, it_x, it_z, valid)
        return counts

    @staticmethod
    def _count_iterations(counts, it_x, it_z, valid) -> None:
        zero = torch.zeros((), dtype=it_x.dtype, device=it_x.device)
        counts["nIterAccX"] = torch.where(valid, it_x, zero).sum()
        counts["nIterAccZ"] = torch.where(valid, it_z, zero).sum()


def _decoder_choice(dec: nn.Module) -> str:
    """The decoder a side resolved to: the class of its (first-stage)
    decoder and, for the QC decoder, whether the slot-stacked flooding
    kernel (`:stacked`), the bf16 state (`:bf16`) and the stacked-update
    writeback (`:vec`) were taken. None is a field of the decoder config
    (each is read from the environment when the decoder is built), and each
    changes the counters."""
    first = dec.decs[0] if hasattr(dec, "decs") else dec
    tags = [":stacked" if getattr(first, "stacked", False) else "",
            ":bf16" if getattr(first, "state_dtype", None) == torch.bfloat16
            else "",
            ":vec" if getattr(first, "vec", False) else ""]
    return type(first).__name__ + "".join(tags)


def _ckpt_id(pipe: ShotPipeline, cfg: SimConfig, seed: int, p, p_index: int,
             kind: str = "p", n_p: int = 0) -> str:
    """Checkpoint identity digest: everything that determines the counter
    stream and its chunk layout. The code itself (Hx/Hz bytes), the fully
    resolved decoder config and the decoder each side resolved to (the
    kernel choice included), the OSD order, layer_compat, the chunk layout
    (batch, RNG tile size and slot count: `chunks_done` only means
    something under the layout that wrote it), shots, seed,
    validate_encoding and where the counts belong: for `kind` "p" the p and
    its p-index, for "sweep" a block of a p-sweep (`p` the block's points,
    `p_index` its first point's index, `n_p` the p-rows). A resume after a
    change to any of these misses the old checkpoint instead of reusing
    stale counts. The device is not part of it: counters do not depend on
    it for MS, and for BP differ only as two runs of a Monte-Carlo estimate
    do."""
    first = pipe.slots[0] if pipe.slots is not None else pipe
    payload = {
        "kind": kind,
        "Hx_shape": list(pipe.Hx.shape), "Hz_shape": list(pipe.Hz.shape),
        "Hx": hashlib.sha256(pipe.Hx.tobytes()).hexdigest(),
        "Hz": hashlib.sha256(pipe.Hz.tobytes()).hexdigest(),
        "dcfg": dataclasses.asdict(pipe.dcfg),
        "decoders": [_decoder_choice(first.dec_x),
                     _decoder_choice(first.dec_z)],
        "osd_order": int(cfg.osd_order),
        "layer_compat": bool(cfg.layer_compat),
        "batch": pipe.batch, "tile": pipe.tile, "n_dev": pipe.n_dev,
        "shots": cfg.shots, "seed": int(seed),
        "validate_encoding": bool(cfg.validate_encoding),
    }
    if kind == "p":
        payload.update(p=f"{p:.17e}", p_index=int(p_index))
    else:
        payload.update(blk0=int(p_index), n_p=int(n_p),
                       ps=[f"{v:.17e}" for v in p])
    blob = json.dumps(payload, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


def _slot_layout(pipe: ShotPipeline, shots: int, c0: int, g: int, key_rows):
    """Keys and valid shots of chunks c0 .. c0 + g - 1 of a `shots`-shot
    run for every global slot of a meshed pipeline: `keys[s]` (g,
    tiles_per_dev, 2) and `n_valids` (slots, g), row-major over (p-row,
    slot of the row), p-row r on key `key_rows[r]`. Slot d of chunk c owns
    global tiles c tpc + d tpd + [0, tpd), and its valid shots are clipped
    to the run's end."""
    n_dev, per_dev, tpd = pipe.n_dev, pipe.per_dev, pipe.tiles_per_dev
    tpc = pipe.tiles_per_chunk
    keys = []
    for key in key_rows:
        row = chunk_keys(key, c0 * tpc, g * tpc).reshape(g, n_dev, tpd, 2)
        keys += [row[:, d] for d in range(n_dev)]
    base = (c0 + np.arange(g)[None, :]) * pipe.batch
    nv = np.clip(shots - base - np.arange(n_dev)[:, None] * per_dev, 0,
                 per_dev)
    return keys, np.tile(nv, (len(key_rows), 1))


def _key_groups(count, totals: torch.Tensor, start_chunk: int,
                n_chunks: int, shots: int, batch: int, after_group):
    """Add the counters of chunks start_chunk .. n_chunks - 1 to `totals`,
    one key group (`_KEY_GROUP_CHUNKS` chunks) at a time: `count(c, g,
    first)` -> the int64 counters of chunks c .. c + g - 1, read after the
    devices are done; `after_group(chunks_done)` after each group. The first
    chunk runs on its own and the warm window starts after it (kernel
    builds land there). Returns (wall seconds, warm seconds or NaN, warm
    shots)."""
    t0 = time.perf_counter()
    t_first = None
    warm_shots = 0
    for c0 in range(start_chunk, n_chunks, _KEY_GROUP_CHUNKS):
        c, c_end = c0, min(c0 + _KEY_GROUP_CHUNKS, n_chunks)
        if t_first is None:
            totals += count(c, 1, True)
            t_first = time.perf_counter()
            c += 1
        if c < c_end:
            totals += count(c, c_end - c, False)
            warm_shots += min(shots, c_end * batch) - c * batch
        after_group(c_end)
    t_end = time.perf_counter()
    warm = t_end - t_first if warm_shots else float("nan")
    return t_end - t0, warm, warm_shots


def simulate_p(Hx: np.ndarray, Hz: np.ndarray, p: float,
               cfg: Optional[SimConfig] = None,
               pipeline: Optional[ShotPipeline] = None,
               p_index: int = 0) -> PPointResult:
    """Monte-Carlo qBLER estimate at one depolarization probability. With
    `cfg.mesh` every chunk is split over the slots of the mesh (all
    processes of it call this together); the counters are the unmeshed
    run's. The first chunk is left out of the warm window; under several
    processes every rank times its own run after the reduction."""
    cfg = cfg or SimConfig()
    pipe = pipeline or ShotPipeline(Hx, Hz, cfg)
    with span("qldpc.job", p_index=p_index):
        shots = cfg.shots
        batch = pipe.batch
        n_chunks = -(-shots // batch)
        tpc = pipe.tiles_per_chunk
        seed = cfg.rng_seed if cfg.rng_seed is not None else 0
        key = fold_in(prng_key(seed, device=pipe.device), p_index)
        progress = cfg.progress and world()[0] == 0

        store = (CheckpointStore(cfg.checkpoint_dir) if cfg.checkpoint_dir
                 else None)
        ckpt_id = (f"p{p_index}_{cfg.dec_type}{cfg.dec_schedule}_"
                   + _ckpt_id(pipe, cfg, seed, p, p_index))
        totals = torch.zeros(len(_COUNTER_KEYS), dtype=torch.int64)
        start_chunk = 0
        if store is not None:
            saved = store.load(ckpt_id)
            if saved is not None:
                totals = torch.tensor([saved[0][k] for k in _COUNTER_KEYS])
                start_chunk = saved[1]

        def count(c, g, first):
            with span("qldpc.group", chunk=c, chunks=g):
                pipe.locate([p_index], c)
                if pipe.slots is not None:
                    keys, nv = _slot_layout(pipe, shots, c, g, [key])
                    return pipe.run_slots(keys, [p], nv)[0]
                # global tile stream: chunk c owns tiles [c tpc, (c + 1) tpc)
                keys = chunk_keys(key, c * tpc, g * tpc).reshape(g, tpc, 2)
                n_valids = [min(batch, shots - i * batch)
                            for i in range(c, c + g)]
                # the first chunk alone on the in-chunk path, but under the
                # group cascade, whose chunks a run's first one must
                # exercise as well
                counts = (pipe._chunk_body(keys[0], p, n_valids[0])
                          if first and pipe.group_cascade is None
                          else pipe._multi_chunk_body(keys, p, n_valids))
                with span("qldpc.readback"):
                    return torch.stack([counts[k].to(torch.int64)
                                        for k in _COUNTER_KEYS]).cpu()

        def after_group(chunks_done):
            if store is not None:
                store.save(ckpt_id, dict(zip(_COUNTER_KEYS,
                                             totals.tolist())), chunks_done)
            if progress:
                print(f"\r(p={p:5.2e}) decoded "
                      f"{min(chunks_done * batch, shots)}/{shots} shots",
                      end="", flush=True)

        wall, warm, warm_shots = _key_groups(
            count, totals, start_chunk, n_chunks, shots, batch, after_group)
        if progress:
            print()
        return _result(p, shots, totals, wall, warm, warm_shots)


def _result(p, shots, totals, wall, warm, warm_shots) -> PPointResult:
    """The result of one p-point from its (9,) counters."""
    counts = dict(zip(_COUNTER_KEYS, totals.tolist()))
    return PPointResult(
        p=float(p),
        shots=shots,
        counters={k: counts[k] for k in _COUNTER_KEYS
                  if not k.startswith("nIter")},
        avg_iterations_x=counts["nIterAccX"] / float(shots),
        avg_iterations_z=counts["nIterAccZ"] / float(shots),
        wall_time_s=wall,
        warm_time_s=warm,
        warm_shots=warm_shots,
    )


def simulate_sweep(Hx: np.ndarray, Hz: np.ndarray, ps: Sequence[float],
                   cfg: SimConfig) -> List[PPointResult]:
    """p-sweep with the p-points as a second axis of slots: the global
    slots of `cfg.mesh` (or of `default_mesh`) form a (cfg.mesh_p, slots /
    mesh_p) grid, row-major, and a block of mesh_p p-points runs at once,
    point i of the block on row i and on its own key branch `fold_in(seed
    key, blk0 + i)`, its chunks split over the row's slots as `simulate_p`
    splits them over a mesh. A short last block leaves its last rows empty
    (no valid shot). Per-p counters equal the serial sweep's; they are
    summed as one (mesh_p, 9) tensor per key group, and with
    `cfg.checkpoint_dir` saved per (p-block, key group).

    Timing: a block's points run together, so `wall_time_s` is the block's
    time divided over its points (the sum over a sweep is its run time),
    while `warm_time_s` is the block's undivided time after its first chunk
    (the port's warm window), so that warm shots/s is the rate at which a
    point's own shots were decoded on its row. A (1, 1) grid is the serial
    loop."""
    n_p = int(cfg.mesh_p)
    if n_p < 1:
        raise ValueError(f"simulate_sweep needs mesh_p >= 1, got {n_p}")
    mesh = cfg.mesh if cfg.mesh is not None else default_mesh(cfg.device, n_p)
    if mesh.size % n_p:
        raise ValueError(f"mesh_p={n_p} must divide the slot count "
                         f"{mesh.size}")
    ps = np.asarray(ps, dtype=np.float64)
    if n_p == 1 and mesh.size == 1:
        scfg = dataclasses.replace(cfg, mesh=None, mesh_p=0,
                                   device=str(mesh.devices[0]))
        pipe = ShotPipeline(Hx, Hz, scfg)
        return [simulate_p(Hx, Hz, pT, scfg, pipeline=pipe, p_index=i)
                for i, pT in enumerate(ps)]
    pipe = ShotPipeline(Hx, Hz, dataclasses.replace(cfg, mesh=mesh),
                        rows=n_p)
    shots, batch = cfg.shots, pipe.batch
    n_chunks = -(-shots // batch)
    seed = cfg.rng_seed if cfg.rng_seed is not None else 0
    base_key = prng_key(seed, device=pipe.device)
    progress = cfg.progress and world()[0] == 0
    store = CheckpointStore(cfg.checkpoint_dir) if cfg.checkpoint_dir else None
    results: List[PPointResult] = []
    for blk0 in range(0, ps.size, n_p):
        with span("qldpc.job", p_index=blk0):
            blk = ps[blk0:blk0 + n_p]
            # the rows past a short block's end repeat its last point
            last = [min(i, blk.size - 1) for i in range(n_p)]
            p_rows = [float(blk[i]) for i in last]
            key_rows = [fold_in(base_key, blk0 + i) for i in last]
            totals = torch.zeros((n_p, len(_COUNTER_KEYS)),
                                 dtype=torch.int64)
            ckpt_id = (f"sweepblk{blk0}_{cfg.dec_type}{cfg.dec_schedule}_"
                       + _ckpt_id(pipe, cfg, seed, blk, blk0, kind="sweep",
                                  n_p=n_p))
            start_chunk = 0
            if store is not None:
                saved = store.load(ckpt_id)
                if saved is not None:
                    totals = torch.tensor(
                        [saved[0][k] for k in _COUNTER_KEYS]).T
                    start_chunk = saved[1]

            def count(c, g, first):
                with span("qldpc.group", chunk=c, chunks=g):
                    pipe.locate([blk0 + i for i in last], c)
                    keys, nv = _slot_layout(pipe, shots, c, g, key_rows)
                    nv[blk.size * pipe.n_dev:] = 0  # rows past the block's end
                    return pipe.run_slots(keys, p_rows, nv)

            def after_group(chunks_done):
                if store is not None:
                    store.save(ckpt_id, dict(zip(
                        _COUNTER_KEYS, totals.T.tolist())), chunks_done)
                if progress:
                    print(f"\r(p-block {blk0 // n_p}) decoded "
                          f"{min(chunks_done * batch, shots)}/{shots} shots x "
                          f"{blk.size} p", end="", flush=True)

            wall, warm, warm_shots = _key_groups(
                count, totals, start_chunk, n_chunks, shots, batch,
                after_group)
            if progress:
                print()
            results += [_result(pT, shots, totals[i], wall / blk.size, warm,
                                warm_shots) for i, pT in enumerate(blk)]
    return results


def simulate(HxFile: str, HzFile: str, p: Sequence[float],
             shots: int = 1000, decType: str = "MS", decIterations: int = 99,
             decSchedule: str = "F", OSDorder: int = -1,
             rngSeed: Optional[int] = None, **kwargs) -> List[PPointResult]:
    """p-sweep with the reference simulator's signature and results table
    (the reference's `simulate`): one pipeline, the p-points one after
    another, each on its own key branch `p_index` = position in `p`; with
    `mesh_p` the points run `mesh_p` at a time (`simulate_sweep`), with the
    same counters. `kwargs` are further `SimConfig` fields; `device`
    defaults to "cuda". Under several processes rank 0 prints the table."""
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
    if cfg.mesh_p:
        results = simulate_sweep(Hx, Hz, p, cfg)
    else:
        pipe = ShotPipeline(Hx, Hz, cfg)
        results = [simulate_p(Hx, Hz, pT, cfg, pipeline=pipe, p_index=i)
                   for i, pT in enumerate(p)]
    if world()[0] == 0:
        print(format_results_table(results))
    return results
