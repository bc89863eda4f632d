"""Incidence-product min-sum and BP decoders (port of
`qldpcsim_tpu/decoders/ms_mxu.py` and `bp_mxu.py`; plain torch, as the
reference's are plain XLA).

The variable-node refresh v2c = posterior - c2v depends on the current state
only, so v2c is never stored: the state is (c2v, posterior), and per layer
(a contiguous run of check rows s .. e-1):

    v2c_l      = posterior @ A_l^T - c2v_l      (A_l: the layer's one-hot
                                                 edge-to-variable incidence)
    new_c2v_l  = check-node update (`checknode.check_node`)
    posterior += (new_c2v_l - c2v_l) @ A_l
    e_hat      = posterior < 0; a shot whose e_hat reproduces its syndrome
                 latches e_hat and n_iter = it + 1 (tested after every layer)

The posterior is updated by deltas, not re-summed, so its float32
association differs from the edge decoders' (`ms.py`, `bp.py`). Nothing is
frozen: a latched shot's posterior keeps moving until the whole batch is
done, while its estimate stays the latched one. The incidence products are
`torch.matmul`, as the reference leaves them to XLA.
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


def _contiguous_ranges(layers: LayerSchedule, m: int):
    """Static (start, end) row ranges of the non-empty layers, or None when
    a layer is not a contiguous run (cross-wired compatibility layers)."""
    ranges = []
    for li in range(layers.n_layers):
        size = int(layers.sizes[li])
        rows = layers.rows[li, :size]
        if size == 0:
            continue
        s, e = int(rows[0]), int(rows[-1]) + 1
        if size != e - s or not (rows == np.arange(s, e)).all():
            return None
        ranges.append((s, e))
    return ranges or None


def supports(graph: TannerGraph, layers: Optional[LayerSchedule],
             max_layers: int = 48) -> bool:
    """The incidence path applies when layers are contiguous and few."""
    if layers is None:
        return True  # flooding
    if layers.n_layers > max_layers:
        return False
    return _contiguous_ranges(layers, graph.m) is not None


class MxuDecoder(nn.Module):
    """decode(syndromes, p) -> DecodeResult, kind MS or BP (the reference's
    `make_ms_mxu_decoder` and `make_bp_mxu_decoder`)."""

    def __init__(self, graph: TannerGraph, cfg: DecoderConfig,
                 layers: Optional[LayerSchedule] = None, kind: str = "MS",
                 device="cpu"):
        super().__init__()
        if layers is None:
            layers = build_layers(graph.H, cfg.schedule.upper())
        self.kind = kind.upper()
        if self.kind not in ("MS", "BP"):
            raise ValueError(f"the incidence decoder runs MS and BP, got "
                             f"{kind!r}")
        self.m, self.n, self.dmax = graph.m, graph.n, graph.dmax
        self.ranges = _contiguous_ranges(layers, graph.m)
        if self.ranges is None:
            raise ValueError("the incidence path requires contiguous layers")
        self.beta = float(np.float32(cfg.beta))
        self.clamp = float(np.float32(1.0 - float(cfg.eps)))
        self.max_iter = int(cfg.max_iter)
        for li, (s, e) in enumerate(self.ranges):
            rv = graph.row_vars[s:e].reshape(-1)
            rm = graph.row_mask[s:e]
            A = np.zeros((rv.size, graph.n), dtype=np.float32)
            idx = np.nonzero(rm.reshape(-1))[0]
            A[idx, rv[idx]] = 1.0
            for name, arr, dt in ((f"A{li}", A, torch.float32),
                                  (f"A_T{li}", A.T, torch.float32),
                                  (f"mask{li}", rm[None], torch.bool)):
                self.register_buffer(name, torch.as_tensor(
                    np.ascontiguousarray(arr), dtype=dt, device=device))
        self.register_buffer("H_T", torch.as_tensor(
            np.ascontiguousarray(graph.H.T), dtype=torch.float32,
            device=device))

    def forward(self, syndromes: torch.Tensor, p) -> DecodeResult:
        B = syndromes.shape[0]
        dev = syndromes.device
        f32 = torch.float32
        syn_f = syndromes.to(f32)                                # (B, m)
        lch = llr_prior(p)
        syn_sign = torch.where(syn_f == 1.0, -1.0, 1.0)
        c2v = torch.zeros((B, self.m, self.dmax), dtype=f32, device=dev)
        posterior = torch.full((B, self.n), lch, dtype=f32, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        e_lat = torch.zeros((B, self.n), dtype=torch.bool, device=dev)
        it_lat = torch.full((B,), self.max_iter, dtype=torch.int32,
                            device=dev)
        for it in range(self.max_iter):
            if bool(done.all()):
                break
            for li, (s, e) in enumerate(self.ranges):
                mask = getattr(self, f"mask{li}")                # (1, L, dmax)
                c2v_l = c2v[:, s:e]                              # (B, L, dmax)
                pos_r = (posterior @ getattr(self, f"A_T{li}")).view(
                    B, e - s, self.dmax)
                mv = torch.where(mask, pos_r - c2v_l, 0.0)
                new_c2v = check_node(self.kind, mv, mask,
                                     syn_sign[:, s:e, None], self.beta,
                                     self.clamp)
                delta = (new_c2v - c2v_l).view(B, (e - s) * self.dmax)
                posterior = posterior + delta @ getattr(self, f"A{li}")
                c2v[:, s:e] = new_c2v
                e_hat = posterior < 0.0
                syn_est = torch.remainder(e_hat.to(f32) @ self.H_T, 2.0)
                ok = (syn_est == syn_f).all(dim=-1)
                newly = ok & ~done
                e_lat = torch.where(newly[:, None], e_hat, e_lat)
                it_lat = torch.where(newly, it + 1, it_lat)
                done = done | ok
        e_hat = torch.where(done[:, None], e_lat, posterior < 0.0)
        return DecodeResult(e_hat=e_hat.to(torch.int8), n_iter=it_lat,
                            converged=done, posterior=posterior)


def make_ms_mxu_decoder(graph: TannerGraph, cfg: DecoderConfig,
                        layers: Optional[LayerSchedule] = None,
                        device="cpu") -> MxuDecoder:
    return MxuDecoder(graph, cfg, layers=layers, kind="MS", device=device)
