"""What the timed window keeps for the check, taken by wrappers installed on
the measured pipeline's own methods (instance attributes, removed again by
`Capture.remove`).

Per job the harness names one chunk (drawn from the seed). Of that chunk it
keeps, as the program produced them: both errors and syndromes
(`_sample_chunk`), both sides' decodes before OSD of a sample of its shots
(`_decode_sides`), the
inputs and outputs of OSD for the chunk's decoder-failed shots (in the
chunk, `_apply_osd`, or in the group-level pass its records reach,
`_osd_group_finish`), and every classification that counts its shots
(`classify`, with its inputs). Of every chunk it keeps the classification's
counters and valid shots and the iteration sums (`_count_iterations`), so
that the job's reported counters can be held to the sum of what its chunks
counted. Kept tensors are cloned on the device and copied to the host
after their job (`JobCapture.move_to_host`), which also sums the chunks'
counters on the device; those sums stay there until the window has
closed.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

EVENTS = ("decSuccessExact", "decSuccessDegen", "DecFailures_X",
          "DecFailures_Z", "successStabilizer", "logicalErrors_X",
          "logicalErrors_Z")


def _keep(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone()


class JobCapture:
    """What one job kept."""

    def __init__(self, job: int, chunk: int, rows):
        """`rows`: the shots of the chunk whose decodes are kept (a CPU
        index tensor)."""
        self.job, self.chunk, self.rows = job, chunk, rows
        self.channel: Optional[tuple] = None      # err_x, err_z, sy_z, sy_x
        self.decode: Dict[str, tuple] = {}        # side -> e, n_iter, conv, post
        self.osd: Dict[str, List[tuple]] = {"x": [], "z": []}
        self.classify: List[tuple] = []           # inputs..., counts
        self.counts: List[Dict[str, torch.Tensor]] = []
        self.valid: List[torch.Tensor] = []
        self.iters: List[tuple] = []
        self.totals: Dict[str, torch.Tensor] = {}

    def _fold(self) -> None:
        """Sum the chunks' event counters, iteration sums and valid shots so
        far into a few int64 tensors on the device and drop the chunks' own,
        so that what a job leaves on the device does not grow with its
        chunks."""
        folds = {"events": ([c[k] for c in self.counts for k in EVENTS],
                            len(EVENTS)),
                 "iters": ([t for pair in self.iters for t in pair], 2)}
        for name, (values, width) in folds.items():
            if values:
                self._add(name, torch.stack(values).view(-1, width).sum(0))
        if self.valid:
            self._add("valid", torch.cat(self.valid).sum())
        self.counts, self.iters, self.valid = [], [], []

    def _add(self, name: str, value: torch.Tensor) -> None:
        old = self.totals.get(name)
        self.totals[name] = value if old is None else old + value

    def move_to_host(self) -> None:
        """Copy the kept chunk to the host and fold the chunks' counters
        (between jobs, so that the device's memory peak stays the
        program's own)."""
        def np_(t):
            return t.detach().cpu().numpy() if torch.is_tensor(t) else t

        self._fold()
        if self.channel is not None:
            self.channel = tuple(np_(t) for t in self.channel)
        self.decode = {s: tuple(np_(t) for t in v)
                       for s, v in self.decode.items()}
        self.osd = {s: [tuple(np_(t) for t in call) for call in v]
                    for s, v in self.osd.items()}
        self.classify = [tuple(np_(t) for t in call[:-1]) + (
            {k: int(v) for k, v in call[-1].items()},)
            for call in self.classify]

    def to_host(self) -> dict:
        """The kept chunk on the host, the chunks' counters summed."""
        self.move_to_host()
        host = {k: v.cpu().tolist() for k, v in self.totals.items()}
        events = host.get("events", [0] * len(EVENTS))
        iters = host.get("iters", [0, 0])
        return {
            "job": self.job, "chunk": self.chunk,
            "channel": self.channel, "decode": self.decode,
            "osd": self.osd, "classify": self.classify,
            "sums": dict(zip(EVENTS, events), nIterAccX=iters[0],
                         nIterAccZ=iters[1]),
            "valid": int(host.get("valid", 0)),
        }


class Capture:
    """The wrappers on one pipeline (a slot of a mesh, or the pipeline)."""

    METHODS = ("_sample_chunk", "_decode_sides", "_apply_osd", "classify",
               "_count_iterations", "_defer", "_osd_group_finish")

    def __init__(self, pipe):
        self.pipe = pipe
        self.job: Optional[JobCapture] = None
        self._chunk_i = 0
        self._here = False          # the current chunk is the kept one
        self._record = None         # its records for the group-level pass
        self._finish: Optional[tuple] = None   # (offset, count) in a pass
        for name in self.METHODS:
            setattr(pipe, name, getattr(self, "_" + name.lstrip("_"))(
                getattr(pipe, name)))

    def remove(self) -> None:
        for name in self.METHODS:
            del self.pipe.__dict__[name]

    def start(self, job: JobCapture) -> None:
        self.job, self._chunk_i, self._here = job, 0, False
        self._record, self._finish = None, None

    def stop(self) -> Optional[JobCapture]:
        job, self.job, self._here = self.job, None, False
        return job

    # the wrappers ------------------------------------------------------
    def _sample_chunk(self, fn):
        def wrapper(tile_keys, p):
            out = fn(tile_keys, p)
            job = self.job
            if job is not None:
                self._here = self._chunk_i == job.chunk
                self._chunk_i += 1
                if self._here:
                    # the syndromes are 0/1: kept as bytes
                    ex, ez, sz, sx = out
                    job.channel = (_keep(ex), _keep(ez), sz.to(torch.uint8),
                                   sx.to(torch.uint8))
            return out
        return wrapper

    def _decode_sides(self, fn):
        def wrapper(sy_z, sy_x, p):
            res_x, res_z = fn(sy_z, sy_x, p)
            if self.job is not None and self._here:
                rows = self.job.rows.to(res_x.e_hat.device)
                for side, r in (("x", res_x), ("z", res_z)):
                    self.job.decode[side] = tuple(
                        t.index_select(0, rows) for t in (
                            r.e_hat, r.n_iter, r.converged, r.posterior))
            return res_x, res_z
        return wrapper

    def _apply_osd(self, fn):
        pipe = self.pipe

        def wrapper(osd, e_hat, post, syn, failed):
            out = fn(osd, e_hat, post, syn, failed)
            job = self.job
            if job is None or not (self._here or self._finish):
                return out
            side = "x" if osd is pipe.osd_x else "z"
            sl = slice(None)
            if self._finish is not None:
                off, cnt = self._finish
                sl = slice(off, off + cnt)
            f = failed[sl]
            job.osd[side].append(tuple(_keep(t[sl][f]) for t in (
                e_hat, syn, post, out)))
            return out
        return wrapper

    def _classify(self, fn):
        def wrapper(err_x, err_z, ex_hat, ez_hat, sy_z, sy_x, valid):
            out = fn(err_x, err_z, ex_hat, ez_hat, sy_z, sy_x, valid)
            job = self.job
            if job is None:
                return out
            job.counts.append(out)
            job.valid.append(valid)
            if self._here or self._finish is not None:
                job.classify.append(tuple(_keep(t) for t in (
                    err_x, err_z, ex_hat, ez_hat, valid))
                    + ({k: _keep(out[k]) for k in EVENTS},))
            return out
        return wrapper

    def _count_iterations(self, fn):
        def wrapper(counts, it_x, it_z, valid):
            fn(counts, it_x, it_z, valid)
            if self.job is not None:
                self.job.iters.append((counts["nIterAccX"],
                                       counts["nIterAccZ"]))
        return wrapper

    def _defer(self, fn):
        def wrapper(*args):
            counts, record = fn(*args)
            if self.job is not None and self._here:
                self._record = record
            return counts, record
        return wrapper

    def _osd_group_finish(self, fn):
        def wrapper(pending):
            rec = self._record
            if self.job is None or rec is None or not any(
                    d is rec for d in pending):
                return fn(pending)
            off = 0
            for d in pending:
                if d is rec:
                    break
                off += d["cx"].shape[0]
            self._finish = (off, rec["cx"].shape[0])
            try:
                return fn(pending)
            finally:
                self._finish, self._record = None, None
        return wrapper
