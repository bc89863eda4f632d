"""Naive-greedy decoder (port of `qldpcsim_tpu/decoders/ng.py`, plain torch).

Per step: score every variable by the number of currently failing checks it
touches (scores = residual @ H), flip the highest-scoring variable (the
first index on ties), update the residual; a shot stops when its residual
clears, when a step finds no positive score, or after 2 n steps. A step is
counted before it is scored, and a zero syndrome reports 0 steps (BF, MS and
BP report 1). Scores are small integers held in float32, so they are exact
on any device. The loop reads `any(active)` on the host once per step.
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


class NGDecoder(nn.Module):
    """decode(syndromes, p=None) -> DecodeResult (posterior None; n_iter is
    the number of steps)."""

    def __init__(self, graph: TannerGraph, cfg: DecoderConfig, device="cpu"):
        super().__init__()
        self.n = graph.n
        self.max_steps = 2 * graph.n
        self.register_buffer("H", torch.as_tensor(
            np.asarray(graph.H), dtype=torch.float32, device=device))
        self.register_buffer("H_T_bool", torch.as_tensor(
            np.ascontiguousarray(graph.H.T != 0), device=device))  # (n, m)

    def forward(self, syndromes: torch.Tensor, p=None) -> DecodeResult:
        B = syndromes.shape[0]
        dev = syndromes.device
        res = syndromes.to(torch.bool)                           # (B, m)
        est = torch.zeros((B, self.n), dtype=torch.bool, device=dev)
        steps = torch.zeros(B, dtype=torch.int32, device=dev)
        broken = torch.zeros(B, dtype=torch.bool, device=dev)
        lanes = torch.arange(B, device=dev)
        while True:
            act = res.any(dim=-1) & (steps < self.max_steps) & ~broken
            if not bool(act.any()):
                break
            steps = steps + act.to(torch.int32)
            scores = res.to(torch.float32) @ self.H
            smax = scores.max(dim=-1).values
            # first index of the maximum, as np.argmax
            v = (scores == smax[:, None]).to(torch.int8).argmax(dim=-1)
            dead = act & (smax == 0.0)           # no failing check scores
            do_flip = act & ~dead
            est[lanes, v] ^= do_flip
            res = res ^ (self.H_T_bool[v] & do_flip[:, None])
            broken = broken | dead
        return DecodeResult(e_hat=est.to(torch.int8), n_iter=steps,
                            converged=~res.any(dim=-1), posterior=None)


def make_ng_decoder(graph: TannerGraph, cfg: DecoderConfig,
                    device="cpu") -> NGDecoder:
    return NGDecoder(graph, cfg, device=device)
