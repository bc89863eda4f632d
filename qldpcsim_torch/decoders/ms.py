"""Edge-layout min-sum and BP decoders (port of `qldpcsim_tpu/decoders/ms.py`
and `bp.py`; plain torch, as the reference's are plain XLA): the reference
simulator's own message schedule, kept as the parity path (`impl="edge"`)
and for layers that are neither contiguous runs nor single rows.

Messages live in a padded (B, m + 1, dmax) edge layout; row m is a dummy
that absorbs the pad slots of a layer. Per layer: the check-node update on
the layer's rows (`checknode.check_node`), then a GLOBAL variable-node
update (the posterior re-summed from all c2v messages, each variable's in
ascending check order), the hard decision's syndrome test with a per-shot
latch of e_hat and n_iter = it + 1, and a global v2c refresh. Nothing is
frozen: the batch iterates until every shot has latched or max_iter.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from qldpcsim_torch.decoders.checknode import check_node
from qldpcsim_torch.decoders.common import (
    DecodeResult,
    DecoderConfig,
    LayerSchedule,
    TannerGraph,
    build_layers,
)
from qldpcsim_torch.ops.ms_qc_cuda import llr_prior


class EdgeDecoder(nn.Module):
    """decode(syndromes, p) -> DecodeResult, kind MS or BP (the reference's
    `make_ms_decoder` and `make_bp_decoder`)."""

    def __init__(self, graph: TannerGraph, cfg: DecoderConfig,
                 layers: Optional[LayerSchedule] = None, kind: str = "MS",
                 device="cpu"):
        super().__init__()
        if layers is None:
            layers = build_layers(graph.H, cfg.schedule.upper())
        self.kind = kind.upper()
        if self.kind not in ("MS", "BP"):
            raise ValueError(f"the edge decoder runs MS and BP, got {kind!r}")
        self.m, self.n, self.dmax = graph.m, graph.n, graph.dmax
        self.n_layers = layers.n_layers
        self.beta = float(np.float32(cfg.beta))
        self.clamp = float(np.float32(1.0 - float(cfg.eps)))
        self.max_iter = int(cfg.max_iter)
        for name, arr, dt in (
                ("layer_rows", layers.rows, torch.int64),        # (L, maxL)
                ("row_vars", np.minimum(graph.row_vars, graph.n - 1),
                 torch.int64),                                   # (m+1, dmax)
                ("row_mask", graph.row_mask, torch.bool),
                ("var_rows", graph.var_rows, torch.int64),       # (n, cmax)
                ("var_slots", graph.var_slots, torch.int64),
                ("var_mask", graph.var_mask, torch.bool),
                ("H_T", graph.H.T, torch.float32)):              # (n, m)
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), dtype=dt, device=device))

    def forward(self, syndromes: torch.Tensor, p) -> DecodeResult:
        B = syndromes.shape[0]
        dev = syndromes.device
        f32 = torch.float32
        syn_f = syndromes.to(f32)                                # (B, m)
        lch = llr_prior(p)
        syn_sign = torch.where(syn_f == 1.0, -1.0, 1.0)
        ss_pad = torch.cat([syn_sign, syn_sign.new_ones((B, 1))], dim=1)
        msg_v2c = torch.where(self.row_mask, lch, 0.0)[None].expand(
            B, self.m + 1, self.dmax)
        msg_c2v = torch.zeros((B, self.m + 1, self.dmax), dtype=f32,
                              device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        e_lat = torch.zeros((B, self.n), dtype=torch.bool, device=dev)
        it_lat = torch.full((B,), self.max_iter, dtype=torch.int32,
                            device=dev)
        posterior = torch.full((B, self.n), lch, dtype=f32, device=dev)
        for it in range(self.max_iter):
            if bool(done.all()):
                break
            for l in range(self.n_layers):
                rows = self.layer_rows[l]                        # (maxL,)
                rmask = self.row_mask[rows][None]        # (1, maxL, dmax)
                msg_c2v[:, rows, :] = check_node(
                    self.kind, msg_v2c[:, rows, :], rmask,
                    ss_pad[:, rows, None], self.beta, self.clamp)
                # global variable-node update, each variable's messages
                # summed in ascending check order
                gathered = torch.where(
                    self.var_mask, msg_c2v[:, self.var_rows, self.var_slots],
                    0.0)                                         # (B, n, cmax)
                vnsum = gathered[:, :, 0]
                for c in range(1, gathered.shape[2]):
                    vnsum = vnsum + gathered[:, :, c]
                posterior = lch + vnsum
                e_hat = posterior < 0.0
                syn_est = torch.remainder(e_hat.to(f32) @ self.H_T, 2.0)
                ok = (syn_est == syn_f).all(dim=-1)
                newly = ok & ~done
                e_lat = torch.where(newly[:, None], e_hat, e_lat)
                it_lat = torch.where(newly, it + 1, it_lat)
                done = done | ok
                # global v2c refresh from the freshest c2v
                msg_v2c = torch.where(self.row_mask,
                                      posterior[:, self.row_vars] - msg_c2v,
                                      0.0)
        e_hat = torch.where(done[:, None], e_lat, posterior < 0.0)
        return DecodeResult(e_hat=e_hat.to(torch.int8), n_iter=it_lat,
                            converged=done, posterior=posterior)


def make_ms_decoder(graph: TannerGraph, cfg: DecoderConfig,
                    layers: Optional[LayerSchedule] = None,
                    device="cpu") -> EdgeDecoder:
    return EdgeDecoder(graph, cfg, layers=layers, kind="MS", device=device)
