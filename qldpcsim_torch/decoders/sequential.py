"""Row-sequential MS/BP decoders for serial schedules over any H (port of
`qldpcsim_tpu/decoders/sequential.py`, plain torch as the reference's is
plain XLA).

The reference simulator's serial schedule updates one check row per layer
and tests convergence after every row. A row update touches only that row's
<= dmax variables:

    v2c_r       = posterior[vars_r] - c2v[r]
    new_c2v_r   = check-node update (min-sum or tanh-product), (B, dmax)
    posterior  += scatter(new_c2v_r - c2v[r])
    syn_est    ^= flips_r @ H[vars_r]        (exact upkeep of H e mod 2)
    latch convergence; converged shots freeze (delta forced to 0), so the
    final posterior's signs are each shot's estimate at convergence.

It serves serial schedules over matrices with no circulant lift, or whose
rows are not in natural order, and `impl="seq"`. It is a Python loop over
rows with batched tensor operations (about 25 per row), with one host
synchronisation per iteration for the early exit: fine for small matrices,
not meant to be fast. Circulant-lifted matrices in natural row order go to
kernel D (`ops/seq_qc_cuda.py`) instead.
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


def supports(layers: Optional[LayerSchedule]) -> bool:
    """The sequential path applies when every layer is a single row."""
    return layers is not None and int(np.max(layers.sizes)) <= 1


class SeqDecoder(nn.Module):
    """decode(syndromes, p) -> DecodeResult, one check row at a time in the
    order of the one-row layers (the reference's `make_seq_decoder`)."""

    def __init__(self, graph: TannerGraph, cfg: DecoderConfig,
                 layers: Optional[LayerSchedule] = None, kind: str = "MS",
                 device="cpu"):
        super().__init__()
        if layers is None:
            layers = build_layers(graph.H, cfg.schedule)
        if not supports(layers):
            raise ValueError("the sequential path requires 1-row layers")
        self.kind = kind.upper()
        if self.kind not in ("MS", "BP"):
            raise ValueError(f"the sequential decoder runs MS and BP, got "
                             f"{kind!r}")
        m, n = graph.m, graph.n
        self.m, self.n, self.dmax = m, n, graph.dmax
        # row order of the schedule (empty padding layers dropped)
        self.order = [int(layers.rows[l, 0]) for l in range(layers.n_layers)
                      if int(layers.sizes[l]) == 1]
        self.beta = float(np.float32(cfg.beta))
        self.clamp = float(np.float32(1.0 - float(cfg.eps)))
        self.max_iter = int(cfg.max_iter)
        row_vars = np.minimum(graph.row_vars[:m], n - 1).astype(np.int64)
        for name, arr, dt in (
                ("row_vars", row_vars, torch.int64),             # (m, dmax)
                ("row_mask", graph.row_mask[:m], torch.bool),    # (m, dmax)
                ("H_T", np.asarray(graph.H.T), torch.float32),   # (n, m)
                ("row_par", np.asarray(graph.H).sum(axis=1) % 2,
                 torch.float32)):                                # (m,)
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), dtype=dt, device=device))

    def forward(self, syndromes: torch.Tensor, p) -> DecodeResult:
        B = syndromes.shape[0]
        dev = syndromes.device
        f32 = torch.float32
        syn_f = syndromes.to(f32)                                # (B, m)
        lch = llr_prior(p)
        syn_sign = torch.where(syn_f == 1.0, -1.0, 1.0)
        c2v = torch.zeros((B, self.m, self.dmax), dtype=f32, device=dev)
        posterior = torch.full((B, self.n), lch, dtype=f32, device=dev)
        # uniform initial hard decision: L_ch < 0 sets every bit
        syn_est = (self.row_par * (1.0 if lch < 0.0 else 0.0))[None, :] \
            .expand(B, self.m).contiguous()
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        it_lat = torch.full((B,), self.max_iter, dtype=torch.int32,
                            device=dev)
        for it in range(self.max_iter):
            if bool(done.all()):
                break
            for r in self.order:
                vars_r = self.row_vars[r]                        # (dmax,)
                mask_r = self.row_mask[r][None]                  # (1, dmax)
                c2v_r = c2v[:, r]                                # (B, dmax)
                pos_r = posterior[:, vars_r]
                mv = torch.where(mask_r, pos_r - c2v_r, 0.0)
                new_c2v = check_node(self.kind, mv, mask_r,
                                     syn_sign[:, r, None], self.beta,
                                     self.clamp)
                active = ~done
                delta = torch.where(mask_r & active[:, None],
                                    new_c2v - c2v_r, 0.0)
                c2v[:, r] = c2v_r + delta
                # pad slots alias variable n - 1 with delta 0
                posterior.index_add_(1, vars_r, delta)
                flips = (((pos_r < 0.0) != ((pos_r + delta) < 0.0))
                         & mask_r).to(f32)
                syn_delta = torch.remainder(flips @ self.H_T[vars_r], 2.0)
                syn_est = (syn_est - syn_delta).abs()            # XOR on 0/1
                ok = (syn_est == syn_f).all(dim=-1)
                it_lat = torch.where(ok & active, it + 1, it_lat)
                done = done | ok
        return DecodeResult(e_hat=(posterior < 0.0).to(torch.int8),
                            n_iter=it_lat, converged=done,
                            posterior=posterior)


def make_seq_decoder(graph: TannerGraph, cfg: DecoderConfig,
                     layers: Optional[LayerSchedule] = None,
                     kind: str = "MS", device="cpu") -> SeqDecoder:
    return SeqDecoder(graph, cfg, layers=layers, kind=kind, device=device)


def make_ms_seq_decoder(graph, cfg, layers=None, device="cpu"):
    return SeqDecoder(graph, cfg, layers=layers, kind="MS", device=device)


def make_bp_seq_decoder(graph, cfg, layers=None, device="cpu"):
    return SeqDecoder(graph, cfg, layers=layers, kind="BP", device=device)
