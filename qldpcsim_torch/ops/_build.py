"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `qldpcsim_torch/csrc/<name>.cu` exposes a plain C interface. On first
use it is compiled for Hopper (`sm_90a`) into `build/qldpcsim_torch/` at the
root of the checkout, under a name that carries a digest of the source and
flags (an edited source rebuilds), and loaded with `ctypes`. A build needs
no PyTorch headers, so it takes seconds.

`-fmad=false` keeps nvcc from contracting a multiply and an add into one
FMA: the kernels promise the same float32 roundings as their plain versions.
A missing nvcc or a failed build raises; nothing falls back.
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

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


def _build(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        BUILD_INFO.setdefault(name, (0.0, "already built"))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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


def load_all(names: Sequence[str]) -> None:
    """Build the named sources at once (one nvcc process each), then load
    them: a cold start waits for the slowest build, not for their sum."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(_build, names))
    for name in names:
        load(name)


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if a C entry point returned a CUDA error (its cudaGetLastError
    right after the launch)."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"CUDA kernel launch in {name}.cu failed: "
                           f"error {rc} ({msg})")
