"""Slots, processes and shot-sharded execution (port of
`qldpcsim_tpu/parallel/mesh.py`).

Shots are independent Monte-Carlo trials, so a run splits its chunks over
slots: each slot is one device driven by one host thread of this process,
and a run may span several processes (`torch.distributed`, one per card or
several sharing one). The p-points of a sweep can be a second axis: the
global slots form a (p-rows, shots) grid, row-major.

RNG discipline as in the reference: tile keys derive from global tile
indices (seed -> p-index -> global tile), never from slot ids, so every
counter is the same whatever the slot count, as long as the 64-shot tile
fits the layout (`engine/montecarlo.py::_tile_size`). The whole reduction is
the nine integer counters per p-row: summed on the host over this process's
slots, then over processes with one `all_reduce` of an int64 CPU tensor on
the gloo backend. Gloo rather than NCCL because two ranks may share one card
(NCCL refuses that) and the counters are host integers after every key
group anyway.

The reference's `cpu_fallback_device`, `shard_chunk_fn`,
`shard_multi_chunk_fn` and `with_perdevice_fallback` are not here: they
are shard_map programs and workarounds for a TPU toolchain. The one exec
mode is the reference's "perdevice".
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import os
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from qldpcsim_torch.parallel.keys import chunk_keys
from qldpcsim_torch.utils.profiling import span

__all__ = ["Mesh", "multihost_init", "make_mesh", "chunk_keys",
           "allreduce_counters_host", "local_mesh_rows",
           "per_device_multi_chunk_fn", "world"]

# Seconds a collective (and the rendezvous) waits for a peer before raising.
DEFAULT_TIMEOUT_S = 600.0

# The launcher's environment, as torchrun sets it.
_LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def multihost_init(init_method: Optional[str] = None,
                   world_size: Optional[int] = None,
                   rank: Optional[int] = None,
                   timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the process group of a multi-process run (gloo backend).

    The context comes from the arguments or, where they are absent, from the
    launcher's environment (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`,
    `RANK`, as torchrun sets them). With no context at all this does
    nothing and returns False; a call in a process that has joined already
    does nothing and returns True. A peer that does not come within
    `timeout_s`, or a collective that waits longer than that, raises."""
    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and all(k in env for k in _LAUNCH_ENV):
        init_method = "env://"
    if init_method is None:
        return False
    if world_size is None:
        world_size = int(env["WORLD_SIZE"])
    if rank is None:
        rank = int(env["RANK"])
    dist.init_process_group(
        "gloo", init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def world() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) outside a process group."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The slots of a run. `devices` are this process's slots, in order;
    they are global slots `first` .. `first + len(devices) - 1` of `size`."""

    devices: Tuple[torch.device, ...]
    size: int
    first: int = 0
    rank: int = 0
    world_size: int = 1


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of this process's slots and its place among all processes.

    With no `devices` the process owns the cards it sees; under a launcher
    that starts several processes on a node (`LOCAL_WORLD_SIZE` > 1) it owns
    the one card `LOCAL_RANK % device_count`. Without a card that raises.
    `devices` names the slots explicitly: `["cpu"] * k` is a k-slot CPU
    mesh in one process, and one card may be named more than once. The
    global slot count and this process's first slot come from one
    all-gather of the local counts when a process group exists."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() owns the cards this process "
                               "sees, and torch sees none; name the slots, "
                               "e.g. make_mesh(['cpu'] * k)")
        n_cards = torch.cuda.device_count()
        if int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > 1:
            local_rank = int(os.environ.get("LOCAL_RANK", "0"))
            devs = [torch.device("cuda", local_rank % n_cards)]
        else:
            devs = [torch.device("cuda", i) for i in range(n_cards)]
    else:
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", 0)
            if d.type not in ("cuda", "cpu"):
                raise ValueError(f"a slot is a CUDA device or the CPU, got {d}")
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one slot")
    rank, world_size = world()
    first, size = 0, len(devs)
    if world_size > 1:
        counts = [torch.zeros(1, dtype=torch.int64)
                  for _ in range(world_size)]
        dist.all_gather(counts, torch.tensor([len(devs)], dtype=torch.int64))
        counts = [int(c) for c in counts]
        first, size = sum(counts[:rank]), sum(counts)
    return Mesh(devices=tuple(devs), size=size, first=first, rank=rank,
                world_size=world_size)


def allreduce_counters_host(counts: torch.Tensor) -> torch.Tensor:
    """Sum an int64 CPU tensor of counters (the nine counters, or per-p rows
    of them) over all processes: one gloo `all_reduce`. A process that is
    alone returns it as it is."""
    if counts.dtype != torch.int64 or counts.device.type != "cpu":
        raise ValueError(f"counters must be an int64 CPU tensor, got "
                         f"{counts.dtype} on {counts.device}")
    with span("qldpc.mesh.allreduce"):
        if world()[1] > 1:
            counts = counts.clone()
            dist.all_reduce(counts, op=dist.ReduceOp.SUM)
        return counts


def local_mesh_rows(mesh: Mesh) -> List[Tuple[int, torch.device]]:
    """(global slot index, device) of this process's slots, in order: the
    rows of a (slots, ...) input that this process works on."""
    return [(mesh.first + i, d) for i, d in enumerate(mesh.devices)]


def _bind(device: torch.device) -> None:
    """A slot thread's start: make its card the thread's current device, so
    that the kernels' launches (which act on the calling thread's device)
    land on it."""
    if device.type == "cuda":
        torch.cuda.set_device(device)


def per_device_multi_chunk_fn(mesh: Mesh, bodies: Sequence[Callable],
                              counter_keys: Sequence[str], rows: int = 1):
    """Shot-sharded execution: each local slot runs its own multi-chunk
    body (`bodies[i]` for `mesh.devices[i]`, a `ShotPipeline.
    _multi_chunk_body` on that device) from its own host thread, and the
    counters are summed on the host, then over processes.

    The returned `run(keys, ps, n_valids)` takes `keys[s]`, the (g, tiles,
    2) tile keys of global slot s for g chunks (any device; a non-local
    slot's entry is not read), `ps[r]`, the p of p-row r, and `n_valids`, a
    (slots, g) array of each slot's valid shots per chunk. Global slot s
    belongs to p-row s // (mesh.size // rows). It returns the (rows,
    len(counter_keys)) int64 CPU tensor of counters, summed over every slot
    of every process. Chunks with no valid shot are not run, nor is a slot
    that has none (its counters are zero)."""
    if mesh.size % rows:
        raise ValueError(f"{rows} p-rows do not divide {mesh.size} slots")
    cards = {d for d in mesh.devices if d.type == "cuda"}
    if len(cards) > 1:
        warnings.warn(
            f"one process drives {len(cards)} cards from its slot threads, "
            "which contend for the host: this runs slower than one card. "
            "Start one process per card: `python -m qldpcsim_torch --mesh` "
            f"or `torchrun --nproc-per-node {len(cards)}`.", RuntimeWarning,
            stacklevel=2)
    per_row = mesh.size // rows
    pools = [concurrent.futures.ThreadPoolExecutor(
        max_workers=1, initializer=_bind, initargs=(d,),
        thread_name_prefix=f"slot{s}") for s, d in local_mesh_rows(mesh)]

    def slot_work(body, device, keys, p, n_valid):
        with span("qldpc.mesh.slot"):
            keep = [i for i, nv in enumerate(n_valid) if nv > 0]
            keys = keys[keep].to(device)
            counts = body(keys, p, [int(n_valid[i]) for i in keep])
            with span("qldpc.readback"):
                return torch.stack([counts[k].to(torch.int64)
                                    for k in counter_keys]).cpu()

    def run(keys, ps, n_valids) -> torch.Tensor:
        n_valids = np.asarray(n_valids)
        futs = []
        for (s, device), pool, body in zip(local_mesh_rows(mesh), pools,
                                           bodies):
            if n_valids[s].sum() == 0:
                continue
            futs.append((s // per_row, pool.submit(
                slot_work, body, device, keys[s], ps[s // per_row],
                n_valids[s])))
        with span("qldpc.mesh.wait"):
            concurrent.futures.wait([f for _, f in futs])
        total = torch.zeros((rows, len(counter_keys)), dtype=torch.int64)
        for row, f in futs:
            total[row] += f.result()  # a slot's error raises here
        return allreduce_counters_host(total)

    return run
