"""Group-deferred cascade: stragglers finish once per key group (port of
`qldpcsim_tpu/engine/group_cascade.py`; opt-in, `QLDPC_GROUP_CASCADE=1`).

The head runs in the chunk: one decode at the cap of the straggler
cascade's last stage but one (10 iterations for MS-L-50, 4 for BP-16). A
shot that did not converge on both sides after the head is a straggler:
its record (both errors, both syndromes, both head estimates and both
converged flags) waits, and the stragglers of many chunks finish together,
each side's unconverged records decoded from scratch at full depth in
dense windows, with OSD on the window's still-unconverged shots when it is
on. MS and BP decode each shot on its own and deterministically, so every
shot gets the in-chunk cascade's result (the head's where it converged,
else a from-scratch full-depth decode) and the counters are the in-chunk
path's, iterations included.

The reference extracts records with a one-hot matmul and, when a chunk has
more stragglers than its fixed deferral capacity, re-runs the whole dispatch
group through the in-chunk path: both exist for the TPU's gathers and
conditionals. Here one `torch.nonzero` takes the stragglers (and brings
their count to the host), an index gather takes their records, and a chunk
with more than `defer_cap` stragglers finishes them in the chunk, with the
same decision tree and without sampling anything again.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from qldpcsim_torch.decoders import make_decoder
from qldpcsim_torch.decoders.cascade import default_stages
from qldpcsim_torch.utils.profiling import span

ENV = "QLDPC_GROUP_CASCADE"

# Full-depth decode window of the group finish (the reference's).
TAIL_WINDOW = 2048

# Most stragglers a chunk defers (the reference's cap, at most a slot's
# share); a chunk with more finishes its stragglers itself.
DEFER_CAP = 512


def enabled(dcfg) -> bool:
    """The opt-in gate: MS or BP with a cascade (more than 12 iterations),
    and `QLDPC_GROUP_CASCADE=1` in the environment."""
    return (dcfg.dec_type.upper() in ("MS", "BP")
            and int(dcfg.max_iter) > 12
            and os.environ.get(ENV) == "1")


class GroupCascade:
    """The group-deferred cascade of one `ShotPipeline` (no mesh): the head
    and tail decoders of each side, built by `make_decoder` from the
    pipeline's graphs and layers, and the chunk and finish bodies.

    Counts of the run: `deferred` (records that waited for a finish),
    `gc_overflows` (chunks whose stragglers exceeded `defer_cap`),
    `tail_lanes` and `tail_windows` per side (full-depth decodes in the
    finish) and `syncs` (host syncs of this module: one `torch.nonzero` per
    chunk and per side of a finish)."""

    def __init__(self, pipe):
        self.pipe = pipe
        # the head stops where the cascade's full-depth stage would start;
        # the tail is the full-depth decoder alone
        dcfg = pipe.dcfg
        head = dataclasses.replace(
            dcfg, max_iter=default_stages(dcfg.max_iter)[-2][0])
        tail = dataclasses.replace(dcfg, round1_iters=-1)

        def decoders(graph, layers):
            return [make_decoder(graph, c, layers=layers, device=pipe.device)
                    for c in (head, tail)]

        self.head_x, self.tail_x = decoders(pipe.graph_x, pipe.layers_x)
        self.head_z, self.tail_z = decoders(pipe.graph_z, pipe.layers_z)
        self.defer_cap = min(pipe.per_dev, DEFER_CAP)
        self.window = TAIL_WINDOW
        self.deferred = 0
        self.gc_overflows = 0
        self.tail_lanes = {"x": 0, "z": 0}
        self.tail_windows = {"x": 0, "z": 0}
        self.syncs = 0

    def chunk(self, tile_keys: torch.Tensor, p, n_valid: int):
        """One chunk: sample, both head decodes, classify the shots that
        converged on both sides, and count every final side's iterations.
        Returns (counters, the stragglers' records or None)."""
        pipe = self.pipe
        with span("qldpc.gcascade.chunk", p_index=pipe.chunk_at[0],
                  chunk=pipe.chunk_at[1]):
            return self._chunk(tile_keys, p, n_valid)

    def _chunk(self, tile_keys: torch.Tensor, p, n_valid: int):
        pipe = self.pipe
        err_x, err_z, sy_z, sy_x = pipe._sample_chunk(tile_keys, p)
        valid = torch.arange(err_x.shape[0], device=pipe.device) < n_valid
        prior = np.float32(p) / np.float32(3.0)
        res_x = self.head_x(sy_z, prior)
        res_z = self.head_z(sy_x, prior)
        strag = ~(res_x.converged & res_z.converged) & valid
        counts = pipe.classify(err_x, err_z, res_x.e_hat, res_z.e_hat, sy_z,
                               sy_x, valid=valid & ~strag)
        # a straggler's converged side is final: its iterations count here,
        # the finish adds only the sides it decodes
        zero = torch.zeros((), dtype=res_x.n_iter.dtype, device=pipe.device)
        for name, res in (("nIterAccX", res_x), ("nIterAccZ", res_z)):
            final = valid & (~strag | res.converged)
            counts[name] = torch.where(final, res.n_iter, zero).sum()
        idx = torch.nonzero(strag).flatten()
        self.syncs += 1
        n_strag = int(idx.numel())
        if n_strag == 0:
            return counts, None
        rec = self._records(idx, err_x, err_z, sy_z, sy_x, res_x, res_z)
        if n_strag > self.defer_cap:
            self.gc_overflows += 1
            extra = self.finish([rec], p)
            return {k: counts[k] + extra[k] for k in counts}, None
        self.deferred += n_strag
        return counts, rec

    @staticmethod
    def _records(idx, err_x, err_z, sy_z, sy_x, res_x, res_z):
        """The records of the shots `idx`: both errors, both syndromes (as
        uint8), both head estimates and both converged flags."""
        return {"err_x": err_x[idx], "err_z": err_z[idx],
                "sy_z": sy_z[idx].to(torch.uint8),
                "sy_x": sy_x[idx].to(torch.uint8),
                "ex": res_x.e_hat[idx], "ez": res_z.e_hat[idx],
                "cx": res_x.converged[idx], "cz": res_z.converged[idx]}

    def _tail(self, side: str, e_head, syn, work, prior):
        """Side `side` of the finish: the `work` records decoded from
        scratch at full depth in windows of at most `window`, OSD on each
        window's unconverged shots -> (estimates, iterations of the
        decoded records)."""
        pipe = self.pipe
        dec = self.tail_x if side == "x" else self.tail_z
        idx = torch.nonzero(work).flatten()
        self.syncs += 1
        n_work = int(idx.numel())
        it = torch.zeros((), dtype=torch.int64, device=pipe.device)
        if n_work == 0:
            return e_head, it
        W = min(self.window, n_work)
        out = e_head.clone()
        for lo in range(0, n_work, W):
            w = idx[lo:lo + W]
            s = syn[w]
            r = dec(s, prior)
            e = r.e_hat
            if pipe.use_osd:
                osd = pipe.osd_x if side == "x" else pipe.osd_z
                e = pipe._apply_osd(osd, e, r.posterior, s, ~r.converged)
            out[w] = e
            it = it + r.n_iter.sum()
            self.tail_windows[side] += 1
        self.tail_lanes[side] += n_work
        return out, it

    def finish(self, pending: List[Dict[str, torch.Tensor]], p
               ) -> Dict[str, torch.Tensor]:
        """The stragglers of `pending` (records of several chunks): each
        side's head-unconverged records through the tail, the head estimate
        kept where that side converged, one classification of every record,
        and the iterations of the decoded sides."""
        with span("qldpc.gcascade.finish"):
            pipe = self.pipe
            rec = {k: torch.cat([d[k] for d in pending]) for k in pending[0]}
            prior = np.float32(p) / np.float32(3.0)
            sy_z = rec["sy_z"].to(torch.float32)   # exact for 0/1
            sy_x = rec["sy_x"].to(torch.float32)
            ex, it_x = self._tail("x", rec["ex"], sy_z, ~rec["cx"], prior)
            ez, it_z = self._tail("z", rec["ez"], sy_x, ~rec["cz"], prior)
            counts = pipe.classify(rec["err_x"], rec["err_z"], ex, ez, sy_z,
                                   sy_x, valid=torch.ones_like(rec["cx"]))
            counts["nIterAccX"] = it_x
            counts["nIterAccZ"] = it_z
            return counts

    def multi_chunk_body(self, keys: torch.Tensor, p, n_valids,
                         pending_max: int) -> Dict[str, torch.Tensor]:
        """Chunks keys[0], keys[1], ... with n_valids[i] valid shots each:
        the chunks' counters, plus a finish whenever `pending_max` records
        wait and one at the end."""
        total: Optional[Dict[str, torch.Tensor]] = None

        def add(counts):
            return counts if total is None else {
                k: total[k] + counts[k] for k in total}

        pending, n_pending = [], 0
        for k, nv in zip(keys, n_valids):
            counts, rec = self.chunk(k, p, int(nv))
            self.pipe.chunk_at[1] += 1
            total = add(counts)
            if rec is not None:
                pending.append(rec)
                n_pending += rec["cx"].shape[0]
            if n_pending >= pending_max:
                total = add(self.finish(pending, p))
                pending, n_pending = [], 0
        if pending:
            total = add(self.finish(pending, p))
        return total
