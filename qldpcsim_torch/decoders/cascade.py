"""Cascaded straggler compaction for iterative decoders (port of
`qldpcsim_tpu/decoders/cascade.py`).

A batched decode runs until every shot has converged, so at realistic p a
few hard shots would drag the whole batch to max_iter. The cascade decodes
the full batch at a shallow iteration cap, then re-decodes the unconverged
tail from scratch at each deeper stage's cap, in fixed-size windows. MS and
BP are deterministic functions of the syndrome, so a from-scratch re-decode
reproduces the continued trajectory exactly: results, posteriors and
iteration counts are bit-identical to one full-depth decode, whatever the
windows.

`make_decoder` skips the cascade where one full-depth launch suffices
(`decoders/__init__.py::_one_launch`). Here the reference's
`lax.while_loop` over windows becomes a Python loop whose trip count comes
from `n_failed`, one host synchronisation per refinement stage reached.

Serial schedules carry the reference's high-p guard: when more than 2/3 of
the batch fails the head, the shallow intermediate stages cannot pay for
themselves, so they are skipped and the tail is decoded once at full depth,
in windows of the second stage's size. The reference gates two window loops
without a conditional; here it is a plain `if` on the `n_failed` the cascade
brings to the host anyway. It changes no result: a from-scratch full-depth
decode of a failed lane gives the same e_hat, n_iter and posterior.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
from torch import nn

from qldpcsim_torch.decoders.common import DecodeResult
from qldpcsim_torch.utils.profiling import span


def default_stages(max_iter: int, batch_hint: int = 4096
                   ) -> List[Tuple[int, float]]:
    """Stage plan [(iters, window fraction of the batch), ...], as in the
    reference: a 4-iteration full-batch head, then shrinking refinement
    stages (1/8 and 1/32 of the batch) up to max_iter."""
    if max_iter <= 12:
        return [(max_iter, 1.0)]
    stages = [(4, 1.0)]
    if max_iter > 24:
        stages.append((10, 1.0 / 8.0))
        stages.append((max_iter, 1.0 / 32.0))
    else:
        stages.append((max_iter, 1.0 / 8.0))
    return stages


def window_size(batch: int, frac: float) -> int:
    """Refinement window of a stage: frac of the batch rounded up to a
    multiple of 64, at least 64, at most the batch (the reference's W)."""
    return min(batch, max(64, -(-int(batch * frac) // 64) * 64))


def tail_order(syndromes: torch.Tensor, converged: torch.Tensor
               ) -> torch.Tensor:
    """Indices of the unconverged lanes, lightest syndrome first (stable), so
    that a refinement window holds stragglers of similar depth. Any order
    gives the same results, since every shot decodes on its own."""
    failed = torch.nonzero(~converged).flatten()
    weight = syndromes[failed].to(torch.float32).sum(dim=1)
    return failed[torch.argsort(weight, stable=True)]


class Cascade(nn.Module):
    """decode(syndromes, p) -> DecodeResult through the stage decoders."""

    def __init__(self, decoders: List[nn.Module],
                 stages: List[Tuple[int, float]], highp_guard: bool = False):
        super().__init__()
        self.decs = nn.ModuleList(decoders)
        self.stages = list(stages)
        self.highp_guard = highp_guard and len(self.stages) > 2
        self.guard_fired = 0  # calls in which the high-p guard took over
        self.stage_lanes = [0] * len(self.stages)  # lanes decoded per stage
        self.syncs = 0  # host syncs: one per refinement stage reached
        self.windows = 0  # refinement windows decoded

    def forward(self, syndromes: torch.Tensor, p) -> DecodeResult:
        """The stages as a host loop over windows of the sorted tail."""
        B = syndromes.shape[0]
        with span("qldpc.cascade.head"):
            r = self.decs[0](syndromes, p)
        self.stage_lanes[0] += B
        e, it, conv, post = r.e_hat, r.n_iter, r.converged, r.posterior
        for level in range(1, len(self.stages)):
            with span("qldpc.cascade.stage", level=level):
                with span("qldpc.cascade.compact"):
                    order = tail_order(syndromes, conv)
                    n_failed = int(order.numel())  # host sync: window count
                self.syncs += 1
                if n_failed == 0:
                    break
                W = window_size(B, self.stages[level][1])
                heavy = (self.highp_guard and level == 1
                         and n_failed > (2 * B) // 3)
                dec = self.decs[-1] if heavy else self.decs[level]
                self.stage_lanes[-1 if heavy else level] += n_failed
                for lo in range(0, n_failed, W):
                    idx = order[lo:lo + W]
                    with span("qldpc.cascade.window", lanes=idx.numel()):
                        s = dec(syndromes[idx], p)
                        e[idx] = s.e_hat
                        it[idx] = s.n_iter
                        conv[idx] = s.converged
                        post[idx] = s.posterior
                    self.windows += 1
                if heavy:  # the tail was decoded at full depth: none is left
                    self.guard_fired += 1
                    break
        return DecodeResult(e_hat=e, n_iter=it, converged=conv,
                            posterior=post)


def make_cascade(decoder_factory, graph, cfg, layers,
                 stages: Optional[List[Tuple[int, float]]] = None):
    """Wrap decoder_factory(graph, cfg, layers=...) in the windowed cascade.

    stages: [(iters, window_frac), ...]; the first stage decodes the whole
    batch (its fraction is ignored) and the last must use cfg.max_iter. A
    one-stage plan returns the plain decoder."""
    if stages is None:
        stages = default_stages(cfg.max_iter)
    if stages[-1][0] != cfg.max_iter:
        raise ValueError(f"the last stage must run cfg.max_iter = "
                         f"{cfg.max_iter} iterations, got {stages}")
    if len(stages) == 1:
        return decoder_factory(graph, cfg, layers=layers)
    decs = [decoder_factory(graph, dataclasses.replace(cfg, max_iter=it),
                            layers=layers) for it, _ in stages]
    return Cascade(decs, stages, highp_guard=cfg.schedule.upper() == "S")


def make_tworound(decoder_factory, graph, cfg, layers, round1_iters: int,
                  cap_frac: float = 0.125):
    """Two-stage special case (explicit round1_iters configs)."""
    if round1_iters >= cfg.max_iter:
        return decoder_factory(graph, cfg, layers=layers)
    return make_cascade(decoder_factory, graph, cfg, layers,
                        stages=[(round1_iters, 1.0), (cfg.max_iter, cap_frac)])
