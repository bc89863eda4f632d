"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `qldpcsim_torch/csrc/<name>.cu` exposes a plain C interface. On first
use it is compiled for Hopper (`sm_90a`) under a name that carries a digest
of the source and flags (an edited source rebuilds), and loaded with
`ctypes`. A build needs no PyTorch headers, so it takes seconds.

Where the libraries go: the directory named by `QLDPC_TORCH_BUILD_DIR` in
the environment if it is set (and nowhere else: an unusable override
raises); otherwise `build/qldpcsim_torch/` beside the package (the root of a
checkout), and when that cannot be created or written (an installed package
under a read-only prefix) the per-user cache directory
`~/.cache/qldpcsim_torch`. That fallback follows `HOME` and nothing else;
`QLDPC_TORCH_BUILD_DIR` is the way to put the libraries anywhere else. When
none is writable the build raises.

`-fmad=false` keeps nvcc from contracting a multiply and an add into one
FMA: the kernels promise the same float32 roundings as their plain versions.
`-split-compile=0` lets nvcc optimise the many template instances of one
source on all cores (the six sources at once: 13.7 s against 22.9 s on the
8-core host of an H100, nvcc 12.9). A missing nvcc or a failed build raises;
nothing falls back.

Under a `torch.distributed` process group `load_all` lets rank 0 build while
the other ranks wait, so that N ranks do not run N nvcc per source.

Every launch acts on the calling thread's current CUDA device (the
`<<<...>>>` and `cudaFuncSetAttribute` of the C side), so each wrapper calls
`require_current` on its tensors' card first: a tensor on another card
raises instead of launching on the wrong one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "qldpcsim_torch"
BUILD_DIR_ENV = "QLDPC_TORCH_BUILD_DIR"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-split-compile=0", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every source of the port, one library each
SOURCES = ("channel", "ms_qc", "gf2_elim", "seq_qc", "general_h", "flood_qc")

_LIBS: Dict[str, ctypes.CDLL] = {}
# name -> (seconds the build took, nvcc's output); filled by builds in this
# process (a library found already built records 0 seconds).
BUILD_INFO: Dict[str, tuple] = {}


def nvcc_path() -> str:
    exe = shutil.which("nvcc")
    if exe:
        return exe
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    exe = os.path.join(home, "bin", "nvcc")
    if os.path.exists(exe):
        return exe
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME "
                       "(default /usr/local/cuda): cannot build the CUDA "
                       "kernels of qldpcsim_torch")


def user_cache_dir() -> Path:
    return Path(os.path.expanduser("~")) / ".cache" / "qldpcsim_torch"


def build_dir() -> Path:
    """The directory the libraries are built into, created and writable:
    the environment's override, else `BUILD_DIR`, else the per-user cache.
    Raises the last OSError when no candidate can be used."""
    override = os.environ.get(BUILD_DIR_ENV)
    candidates = [Path(override)] if override else [BUILD_DIR,
                                                    user_cache_dir()]
    for path in candidates:
        try:
            path.mkdir(parents=True, exist_ok=True)
            if not os.access(path, os.W_OK | os.X_OK):
                raise PermissionError(f"{path} is not writable")
            return path
        except OSError as exc:
            err = exc
    raise OSError(f"no writable build directory for the CUDA kernels among "
                  f"{[str(c) for c in candidates]} (set {BUILD_DIR_ENV})"
                  ) from err


def _build(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = build_dir() / f"{name}-{digest}.so"
    if out.exists():
        BUILD_INFO.setdefault(name, (0.0, "already built"))
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {src} (rc "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    BUILD_INFO[name] = (secs, proc.stdout + proc.stderr)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(_build(name)))
        err = getattr(lib, f"{name}_error_string")
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def _build_many(names: Sequence[str]) -> None:
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(_build, names))


def load_all(names: Sequence[str] = SOURCES) -> None:
    """Build the named sources at once (one nvcc process each), then load
    them: a cold start waits for the slowest build, not for their sum.
    Under a process group of several ranks, rank 0 builds and the others
    wait for it (a broadcast of its outcome), then every rank loads; a
    failed build raises on every rank."""
    import torch.distributed as dist

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        _build_many(names)
    else:
        import torch

        ok = torch.ones(1, dtype=torch.int64)
        err = None
        if dist.get_rank() == 0:
            try:
                _build_many(names)
            except Exception as exc:  # every rank learns of it below
                ok.zero_()
                err = exc
        dist.broadcast(ok, src=0)
        if err is not None:
            raise err
        if not int(ok):
            raise RuntimeError("rank 0 failed to build the CUDA kernels")
    for name in names:
        load(name)


def require_current(device) -> None:
    """Raise unless `device` (a CUDA device) is the calling thread's current
    one, where a launch would land."""
    import torch

    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise RuntimeError(f"a kernel for {device} launched while cuda:"
                           f"{current} is the current device; call "
                           f"torch.cuda.set_device({device.index}) first")


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError
    right after the launch)."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"CUDA kernel launch in {name}.cu failed: "
                           f"error {rc} ({msg})")
