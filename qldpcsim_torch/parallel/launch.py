"""Start a run as one process per card of this host.

Slot threads of one process contend for the host (a chunk's host work is
Python and torch dispatch under one interpreter lock), so a mesh over
several cards in one process runs slower than one card, while one process
per card scales. `launch_local(n, argv)` runs `python -m qldpcsim_torch
ARGV` as n ranks with the launcher's environment that torchrun would set
(`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`,
`LOCAL_WORLD_SIZE`); each rank joins the gloo process group and owns the
card of its local rank (`parallel/mesh.py::make_mesh`). A rank finds that
environment set and so never launches again.

Rank 0's standard output is the run's, unbuffered and streamed as it
comes (progress lines too); the other ranks' is dropped (they print
nothing but what rank 0 prints too). Every rank's standard error is kept in a file and written out, rank by rank,
when the run ends. The first rank that exits non-zero ends the run: its
peers are killed at once, so a rank that dies at import does not leave the
others waiting out the rendezvous timeout, and its status is returned.
Ctrl-C kills every rank too.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Sequence

import qldpcsim_torch
from qldpcsim_torch.parallel.mesh import _LAUNCH_ENV

__all__ = ["launch_local", "launched"]

# The launcher's environment, as torchrun sets it (`multihost_init` joins
# the process group from the first four).
LAUNCH_ENV = _LAUNCH_ENV + ("LOCAL_RANK", "LOCAL_WORLD_SIZE")
_POLL_S = 0.05
_PORT_TAKEN = ("address already in use", "eaddrinuse")


def launched() -> bool:
    """True when this process runs under a launcher (any of its variables
    is set), so it must not launch again."""
    return any(k in os.environ for k in LAUNCH_ENV)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_once(n: int, argv: Sequence[str], errs: List,
              prog: Sequence[str]) -> int:
    """One launch of n ranks of `python PROG ARGV`; their standard error
    goes to `errs`' files. Returns 0, or the status of the first rank that
    failed."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        qldpcsim_torch.__file__)))
    path = os.environ.get("PYTHONPATH")
    base = dict(os.environ, MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(_free_port()), WORLD_SIZE=str(n),
                LOCAL_WORLD_SIZE=str(n), PYTHONUNBUFFERED="1",
                PYTHONPATH=root if not path else root + os.pathsep + path)
    procs = []
    sys.stdout.flush()  # what this process printed comes before rank 0's
    try:
        for rank in range(n):
            env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
            procs.append(subprocess.Popen(
                [sys.executable, *prog, *argv], env=env,
                stdout=None if rank == 0 else subprocess.DEVNULL,
                stderr=errs[rank]))
        while True:
            codes = [p.poll() for p in procs]
            bad = [c for c in codes if c not in (None, 0)]
            if bad:
                return bad[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(_POLL_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def launch_local(n: int, argv: Sequence[str],
                 prog: Sequence[str] = ("-m", "qldpcsim_torch")) -> int:
    """Run `python PROG ARGV` (the command line by default; `prog=(script,)`
    runs a script) as n ranks of one process group on this host, rank r on
    card r. Returns 0 when every rank exits 0, else
    the status of the first rank that failed (its peers are killed then).
    A port taken between its probe and rank 0's bind is retried once on
    another port."""
    if n < 1:
        raise ValueError(f"a launch needs at least one rank, got {n}")
    for attempt in range(2):
        with tempfile.TemporaryDirectory(prefix="qldpc_launch_") as tmp:
            errs = [open(os.path.join(tmp, f"err.{r}"), "w+")
                    for r in range(n)]
            try:
                rc = _run_once(n, argv, errs, prog)
                texts = []
                for f in errs:
                    f.seek(0)
                    texts.append(f.read())
            finally:
                for f in errs:
                    f.close()
        retry = (rc != 0 and attempt == 0
                 and any(s in t.lower() for t in texts for s in _PORT_TAKEN))
        for r, text in enumerate(texts):
            if text and not retry:
                sys.stderr.write(text if r == 0 else f"[rank {r}]\n{text}")
        sys.stderr.flush()
        if not retry:
            return rc
    return rc
