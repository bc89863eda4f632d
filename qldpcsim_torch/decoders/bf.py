"""Bit-flipping decoder (port of `qldpcsim_tpu/decoders/bf.py`, plain torch).

Per iteration: count the unsatisfied checks of every variable through the
residual syndrome (nuc = r @ H), flip every variable whose count exceeds
half its check degree, recompute the residual; stop on a zero residual or
after `cfg.bf_max_iter` iterations. Converged shots are frozen. All values
are small integers held in float32, so the products are exact on any
device.

`cfg.bf_residual`: "mod2" is the parity of the overlap H @ e_hat (the
standard residual); "bool" is `(H @ e_hat > 0) XOR syndrome`, any overlap,
which is what the reference simulator computes and a different decoder on
rows that meet two or more flipped variables.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from qldpcsim_torch.decoders.common import (
    DecodeResult,
    DecoderConfig,
    TannerGraph,
)


class BFDecoder(nn.Module):
    """decode(syndromes, p=None) -> DecodeResult (posterior None)."""

    def __init__(self, graph: TannerGraph, cfg: DecoderConfig, device="cpu"):
        super().__init__()
        if cfg.bf_residual not in ("mod2", "bool"):
            raise ValueError(f"bf_residual must be 'mod2' or 'bool', "
                             f"got {cfg.bf_residual!r}")
        self.ref_bool = cfg.bf_residual == "bool"
        self.max_iter = int(cfg.bf_max_iter)
        self.n = graph.n
        H = np.asarray(graph.H, dtype=np.float32)
        for name, arr in (("H", H), ("H_T", H.T),
                          ("half_deg", H.sum(axis=0) * 0.5)):
            self.register_buffer(name, torch.as_tensor(
                np.ascontiguousarray(arr), dtype=torch.float32,
                device=device))

    def forward(self, syndromes: torch.Tensor, p=None) -> DecodeResult:
        B = syndromes.shape[0]
        dev = syndromes.device
        syn_f = syndromes.to(torch.float32)                      # (B, m)
        e = torch.zeros((B, self.n), dtype=torch.bool, device=dev)
        r = syn_f
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        it_lat = torch.full((B,), self.max_iter, dtype=torch.int32,
                            device=dev)
        for it in range(self.max_iter):
            if bool(done.all()):
                break
            flip = (r @ self.H) > self.half_deg
            e_new = e ^ flip
            overlap = e_new.to(torch.float32) @ self.H_T
            s_hat = ((overlap > 0.0).to(torch.float32) if self.ref_bool
                     else torch.remainder(overlap, 2.0))
            r_new = (s_hat - syn_f).abs()                        # XOR on 0/1
            e = torch.where(done[:, None], e, e_new)
            r = torch.where(done[:, None], r, r_new)
            ok = (r == 0.0).all(dim=-1)
            it_lat = torch.where(ok & ~done, it + 1, it_lat)
            done = done | ok
        return DecodeResult(e_hat=e.to(torch.int8), n_iter=it_lat,
                            converged=done, posterior=None)


def make_bf_decoder(graph: TannerGraph, cfg: DecoderConfig,
                    device="cpu") -> BFDecoder:
    return BFDecoder(graph, cfg, device=device)
