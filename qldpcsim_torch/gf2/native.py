"""ctypes binding of the native GF(2) core `csrc/gf2core.cpp` (the port's
copy of `qldpcsim_tpu/gf2/native.py`, over the same C ABI).

The library is built with g++ on first use from the repository's
`csrc/gf2core.cpp`, into the port's build directory (`ops/_build.
build_dir()`), under a name that carries a digest of the source and the
flags: an edited source rebuilds. Each build writes a name of its own
process and renames it into place, so that several processes can build at
once. After loading, the library's ABI version must be `ABI_VERSION`.

`dense.rank` and `dense._eliminate_packed` dispatch to it;
`QLDPC_NATIVE=0` in the environment turns that off (read at every call).
When the library cannot be built or loaded, the first call warns once,
with the compiler's error, and the numpy path runs: it gives the same
pivots, ranks and bases. This is host-side set-up, never the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

# Must equal gf2core_abi_version() in csrc/gf2core.cpp.
ABI_VERSION = 2

SRC = Path(__file__).resolve().parents[2] / "csrc" / "gf2core.cpp"
# No -march=native (the reference's): a build directory may be copied to, or
# shared with, another host, and the library's name does not say whose CPU
# it was built for. ISO C++ keeps g++ from contracting into fmas either way.
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_LIB: Optional[ctypes.CDLL] = None
_FAILED: Optional[str] = None   # why the library is unavailable, once known
LIB_PATH: Optional[Path] = None  # the library loaded, once loaded


def _abi_version(lib) -> int:
    """The ABI version the library exports (0 if it predates the call)."""
    if not hasattr(lib, "gf2core_abi_version"):
        return 0
    lib.gf2core_abi_version.restype = ctypes.c_int
    lib.gf2core_abi_version.argtypes = []
    return int(lib.gf2core_abi_version())


def _build() -> Path:
    """The library's path, built first when it is not there. Raises with
    the compiler's output when the build fails."""
    from qldpcsim_torch.ops._build import build_dir

    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = build_dir() / f"gf2core-{digest}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC} (rc "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)   # a fresh inode: dlopen never maps a stale one
    return out


def _bind(lib: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    c_int = ctypes.c_int
    lib.gf2_eliminate.restype = c_int
    lib.gf2_eliminate.argtypes = [u64p, c_int, c_int, c_int, u64p, c_int,
                                  c_int, i32p]
    lib.gf2_rank.restype = c_int
    lib.gf2_rank.argtypes = [u64p, c_int, c_int, c_int]
    ms_args = [i8p, c_int, c_int, i8p, c_int, ctypes.c_float, c_int,
               ctypes.c_float, i32p, i32p, c_int, i8p, i32p, i8p, f32p]
    lib.ms_decode_cpu.restype = c_int
    lib.ms_decode_cpu.argtypes = ms_args
    lib.ms_decode_cpu_mt.restype = c_int
    lib.ms_decode_cpu_mt.argtypes = ms_args + [c_int]
    bp_args = [i8p, c_int, c_int, i8p, c_int, ctypes.c_double, c_int,
               i32p, i32p, c_int, i8p, i32p, i8p, f64p]
    lib.bp_decode_cpu.restype = c_int
    lib.bp_decode_cpu.argtypes = bp_args
    lib.bp_decode_cpu_mt.restype = c_int
    lib.bp_decode_cpu_mt.argtypes = bp_args + [c_int]
    lib.osd_decode_cpu.restype = c_int
    lib.osd_decode_cpu.argtypes = [i8p, c_int, c_int, c_int, i8p, i8p, f64p,
                                   c_int, c_int, i8p]


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None under `QLDPC_NATIVE=0`
    or when it cannot be built or loaded (warned once, with the reason)."""
    global _LIB, _FAILED, LIB_PATH
    if os.environ.get("QLDPC_NATIVE", "1") == "0":
        return None
    if _LIB is not None or _FAILED is not None:
        return _LIB
    try:
        path = _build()
        lib = ctypes.CDLL(str(path))
        version = _abi_version(lib)
        if version != ABI_VERSION:
            raise RuntimeError(f"{path} exports ABI version {version}, the "
                               f"binding needs {ABI_VERSION}")
        _bind(lib)
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        _FAILED = f"{type(exc).__name__}: {exc}"
        warnings.warn("the native GF(2) core is unavailable, the numpy "
                      f"elimination runs instead: {_FAILED}", RuntimeWarning,
                      stacklevel=2)
        return None
    _LIB, LIB_PATH = lib, path
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _packed(a: np.ndarray, what: str) -> np.ndarray:
    """`a` itself, which the library reads and writes in place."""
    if (a.dtype != np.uint64 or a.ndim != 2 or not a.flags.c_contiguous
            or not a.flags.writeable):
        raise ValueError(f"{what} must be a writeable C-contiguous (rows, "
                         f"words) uint64 array, got {a.dtype} {a.shape}")
    return a


def rank_native(packed: np.ndarray, n: int) -> Optional[int]:
    """Rank of the packed rows (`dense.pack_rows`) of an n-column matrix,
    or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    P = np.ascontiguousarray(packed, dtype=np.uint64)
    return int(lib.gf2_rank(_ptr(P, ctypes.c_uint64), P.shape[0], n,
                            P.shape[1]))


def eliminate_native(packed: np.ndarray, n: int, T: Optional[np.ndarray],
                     reduced: bool):
    """Elimination of the packed rows in place (reduced: RREF, else REF),
    the same row operations applied to T when it is given. Returns the
    pivot columns, or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    R = _packed(packed, "packed")
    m, words = R.shape
    pivots = np.full(max(1, min(m, n)), -1, dtype=np.int32)
    if T is not None:
        T = _packed(T, "T")
        tptr, twords = _ptr(T, ctypes.c_uint64), T.shape[1]
    else:
        tptr, twords = ctypes.POINTER(ctypes.c_uint64)(), 0
    r = lib.gf2_eliminate(_ptr(R, ctypes.c_uint64), m, n, words, tptr,
                          twords, 1 if reduced else 0,
                          _ptr(pivots, ctypes.c_int32))
    return [int(p) for p in pivots[:r]]


def _layer_ranges(layers):
    starts = np.asarray([int(l[0]) if len(l) else 0 for l in layers],
                        np.int32)
    ends = np.asarray([int(l[-1]) + 1 if len(l) else 0 for l in layers],
                      np.int32)
    return starts, ends


def ms_decode_native(H: np.ndarray, syndromes: np.ndarray, p: float,
                     max_iter: int, layers, beta: float = 0.75,
                     threads: int = 0):
    """Batched CPU min-sum with the reference simulator's update rules
    (threads 0: all cores; the result does not depend on it). Returns
    (e_hat (B, n) int8, n_iter (B,) int32, converged (B,) bool, posterior
    (B, n) float32), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    H = np.ascontiguousarray(H, dtype=np.int8)
    syn = np.ascontiguousarray(syndromes, dtype=np.int8)
    m, n = H.shape
    B = syn.shape[0]
    starts, ends = _layer_ranges(layers)
    e_out = np.zeros((B, n), np.int8)
    iters = np.zeros(B, np.int32)
    conv = np.zeros(B, np.int8)
    post = np.zeros((B, n), np.float32)
    lib.ms_decode_cpu_mt(
        _ptr(H, ctypes.c_int8), m, n, _ptr(syn, ctypes.c_int8), B,
        ctypes.c_float(p), max_iter, ctypes.c_float(beta),
        _ptr(starts, ctypes.c_int32), _ptr(ends, ctypes.c_int32),
        len(layers), _ptr(e_out, ctypes.c_int8), _ptr(iters, ctypes.c_int32),
        _ptr(conv, ctypes.c_int8), _ptr(post, ctypes.c_float), threads)
    return e_out, iters, conv.astype(bool), post


def bp_decode_native(H: np.ndarray, syndromes: np.ndarray, p: float,
                     max_iter: int, layers, threads: int = 0):
    """Batched CPU BP in float64 with the reference simulator's numerics
    (see `bp_decode_cpu` in the source). Returns (e_hat int8, n_iter int32,
    converged bool, posterior float64), or None without the library."""
    lib = get_lib()
    if lib is None:
        return None
    H = np.ascontiguousarray(H, dtype=np.int8)
    syn = np.ascontiguousarray(syndromes, dtype=np.int8)
    m, n = H.shape
    B = syn.shape[0]
    starts, ends = _layer_ranges(layers)
    e_out = np.zeros((B, n), np.int8)
    iters = np.zeros(B, np.int32)
    conv = np.zeros(B, np.int8)
    post = np.zeros((B, n), np.float64)
    lib.bp_decode_cpu_mt(
        _ptr(H, ctypes.c_int8), m, n, _ptr(syn, ctypes.c_int8), B,
        ctypes.c_double(p), max_iter, _ptr(starts, ctypes.c_int32),
        _ptr(ends, ctypes.c_int32), len(layers), _ptr(e_out, ctypes.c_int8),
        _ptr(iters, ctypes.c_int32), _ptr(conv, ctypes.c_int8),
        _ptr(post, ctypes.c_double), threads)
    return e_out, iters, conv.astype(bool), post


def osd_decode_native(H: np.ndarray, e_hat: np.ndarray, syndromes: np.ndarray,
                      posterior: np.ndarray, order: int):
    """Batched CPU OSD post-decode (see `osd_decode_cpu` in the source).
    Returns (B, n) int8, or None without the library."""
    from qldpcsim_torch.gf2.dense import rank

    lib = get_lib()
    if lib is None:
        return None
    H = np.ascontiguousarray(H, dtype=np.int8)
    m, n = H.shape
    e_in = np.ascontiguousarray(e_hat, dtype=np.int8)
    syn = np.ascontiguousarray(syndromes, dtype=np.int8)
    post = np.ascontiguousarray(posterior, dtype=np.float64)
    B = e_in.shape[0]
    e_out = np.zeros((B, n), np.int8)
    lib.osd_decode_cpu(_ptr(H, ctypes.c_int8), m, n, rank(H),
                       _ptr(e_in, ctypes.c_int8), _ptr(syn, ctypes.c_int8),
                       _ptr(post, ctypes.c_double), B, int(order),
                       _ptr(e_out, ctypes.c_int8))
    return e_out
