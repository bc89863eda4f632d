"""The port's binding of the native GF(2) core (`qldpcsim_torch/gf2/
native.py` over `csrc/gf2core.cpp`, the twin of tests/test_native.py): rank
and elimination (with the transform) against the numpy path and the JAX
package's binding, the dispatch of `gf2.rank` and `gf2.ref`, the min-sum
decoder against tests/oracle.py, BP and OSD against the JAX binding, the ABI
handshake, `QLDPC_NATIVE=0`, where the library is built, and the warning
and numpy path when it cannot be built."""

import os
import subprocess

import numpy as np
import pytest

import oracle
from qldpcsim_tpu import gf2 as ref_gf2
from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.gf2 import native as ref_native

from qldpcsim_torch import gf2
from qldpcsim_torch.decoders import layerize
from qldpcsim_torch.gf2 import native
from qldpcsim_torch.gf2.dense import _eliminate_packed, pack_rows, unpack_rows
from qldpcsim_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    assert lib is not None, "g++ builds csrc/gf2core.cpp here"
    return lib


@pytest.fixture
def fresh(monkeypatch):
    """The binding with nothing loaded yet (restored afterwards)."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_FAILED", None)
    monkeypatch.setattr(native, "LIB_PATH", None)
    return native


def _numpy_path(monkeypatch):
    monkeypatch.setenv("QLDPC_NATIVE", "0")


@pytest.mark.parametrize("seed", range(4))
def test_rank_equals_numpy_and_jax(monkeypatch, lib, seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        m, n = int(rng.integers(1, 60)), int(rng.integers(1, 130))
        A = (rng.random((m, n)) < 0.3).astype(np.uint8)
        P = pack_rows(A)
        got = native.rank_native(P, n)
        assert got == ref_native.rank_native(ref_gf2.pack_rows(A), n)
        with monkeypatch.context() as mp:
            _numpy_path(mp)
            assert native.rank_native(P, n) is None
            piv, _ = _eliminate_packed(P.copy(), n, reduced=False)
            assert gf2.rank(A) == len(piv)
        assert got == len(piv) == gf2.rank(A)


@pytest.mark.parametrize("reduced", [True, False])
def test_eliminate_with_transform(monkeypatch, lib, reduced):
    """R = T A over GF(2), each pivot alone in its column (reduced) or below
    its row (echelon), and R, T and the pivots equal the JAX binding's and
    the numpy path's."""
    rng = np.random.default_rng(int(reduced))
    A = (rng.random((12, 20)) < 0.4).astype(np.uint8)
    R, T = pack_rows(A), pack_rows(np.eye(12, dtype=np.uint8))
    piv = native.eliminate_native(R, 20, T, reduced=reduced)
    B, Tm = unpack_rows(R, 20), unpack_rows(T, 12)
    assert (B == gf2.mat_mul(Tm, A)).all()
    for i, p in enumerate(piv):
        col = B[:, p].copy()
        assert col[i] == 1
        col[i] = 0
        assert not (col if reduced else col[i + 1:]).any()
    R2 = ref_gf2.pack_rows(A)
    T2 = ref_gf2.pack_rows(np.eye(12, dtype=np.uint8))
    assert ref_native.eliminate_native(R2, 20, T2, reduced) == piv
    np.testing.assert_array_equal(R, R2)
    np.testing.assert_array_equal(T, T2)
    R3, T3 = pack_rows(A), pack_rows(np.eye(12, dtype=np.uint8))
    _numpy_path(monkeypatch)
    piv3, r3 = _eliminate_packed(R3, 20, T=T3, reduced=reduced)
    assert piv3 == piv and r3 == len(piv)
    np.testing.assert_array_equal(R, R3)
    np.testing.assert_array_equal(T, T3)


def test_eliminate_refuses_a_copy(lib):
    """The library writes the rows in place: a non-contiguous or non-uint64
    array raises instead of being eliminated as a silent copy."""
    P = pack_rows(np.eye(8, dtype=np.uint8))
    with pytest.raises(ValueError):
        native.eliminate_native(P[::2], 8, None, True)
    with pytest.raises(ValueError):
        native.eliminate_native(P.astype(np.int64), 8, None, True)


@pytest.mark.parametrize("code", ["lp04_0", "steane", "bicycle"])
def test_dispatch_of_rank_and_ref(monkeypatch, lib, code):
    """gf2.rank, gf2.ref and gf2.rref of a library code's matrices through
    the native core equal the numpy path's and the JAX package's."""
    H = np.asarray(get_code(code).Hx)
    got = (gf2.rank(H), gf2.ref(H), gf2.rref(H))
    want = (ref_gf2.rank(H), ref_gf2.ref(H), ref_gf2.rref(H))
    _numpy_path(monkeypatch)
    plain = (gf2.rank(H), gf2.ref(H), gf2.rref(H))
    for g in (want, plain):
        assert got[0] == g[0]
        for a, b in zip(got[1:], g[1:]):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert list(a[2]) == list(b[2])


def test_ms_decode_equals_the_oracle(lib):
    """The twin of test_native_ms_matches_oracle: decisions, iterations and
    convergence exact, the posterior to 1e-3 (the C++ sums a variable's
    messages in order, numpy pairwise); and equal to the JAX binding's."""
    H = np.asarray(get_code("lp04_0").Hz)
    rng = np.random.default_rng(3)
    errs = (rng.random((24, H.shape[1])) < 0.05).astype(np.int8)
    syn = ((errs.astype(np.int64) @ H.T.astype(np.int64)) % 2).astype(np.int8)
    layers = layerize(H)
    e_hat, iters, conv, post = native.ms_decode_native(H, syn, 0.02, 12,
                                                       layers)
    for s in range(syn.shape[0]):
        e_ref, it_ref, post_ref, conv_ref = oracle.ms_decode(
            H, syn[s], 0.02, 12, layers)
        assert conv[s] == conv_ref and iters[s] == it_ref, s
        assert (e_hat[s] == e_ref).all(), s
        assert np.allclose(post[s], post_ref, rtol=1e-3, atol=1e-3), s
    for a, b in zip((e_hat, iters, conv, post),
                    ref_native.ms_decode_native(H, syn, 0.02, 12, layers)):
        np.testing.assert_array_equal(a, b)


def test_bp_and_osd_equal_the_jax_binding(lib):
    H = np.asarray(get_code("lp04_0").Hz)
    rng = np.random.default_rng(4)
    errs = (rng.random((16, H.shape[1])) < 0.08).astype(np.int8)
    syn = ((errs.astype(np.int64) @ H.T.astype(np.int64)) % 2).astype(np.int8)
    layers = layerize(H)
    got = native.bp_decode_native(H, syn, 0.05, 10, layers)
    want = ref_native.bp_decode_native(H, syn, 0.05, 10, layers)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    e_osd = native.osd_decode_native(H, got[0], syn, got[3], 2)
    np.testing.assert_array_equal(
        e_osd, ref_native.osd_decode_native(H, got[0], syn, got[3], 2))
    assert (((e_osd.astype(np.int64) @ H.T) % 2) == syn).all()


def test_abi_handshake(lib):
    assert native.ABI_VERSION == ref_native._ABI_VERSION == 2
    assert native._abi_version(lib) == native.ABI_VERSION


def test_qldpc_native_0_turns_it_off(monkeypatch, lib):
    """Under QLDPC_NATIVE=0 the binding gives no library (read at each
    call, after a load too) and the dispatch runs numpy."""
    _numpy_path(monkeypatch)
    assert native.get_lib() is None
    P = pack_rows(np.eye(5, dtype=np.uint8))
    assert native.rank_native(P, 5) is None
    assert native.eliminate_native(P, 5, None, True) is None
    assert native.ms_decode_native(np.eye(2), np.zeros((1, 2)), 0.1, 2,
                                   [np.arange(2)]) is None
    assert gf2.rank(np.eye(5, dtype=np.uint8)) == 5
    monkeypatch.setenv("QLDPC_NATIVE", "1")
    assert native.get_lib() is lib


def test_builds_into_the_ports_build_directory(monkeypatch, tmp_path, fresh):
    """The library lands in `_build.build_dir()` (here the environment's
    override), under a per-process temporary name renamed into place;
    nothing is written anywhere else, and nothing under qldpcsim_tpu/."""
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path))
    written = []
    run, replace = subprocess.run, os.replace

    def spy_run(cmd, *a, **k):
        written.append(cmd[cmd.index("-o") + 1])
        return run(cmd, *a, **k)

    def spy_replace(src, dst):
        written.append(str(dst))
        return replace(src, dst)

    monkeypatch.setattr(native.subprocess, "run", spy_run)
    monkeypatch.setattr(native.os, "replace", spy_replace)
    assert fresh.get_lib() is not None
    assert fresh.LIB_PATH.parent == tmp_path
    assert fresh.LIB_PATH.name.startswith("gf2core-")
    assert len(written) == 2 and f".{os.getpid()}.tmp" in written[0]
    tpu = os.path.join(ROOT, "qldpcsim_tpu")
    for path in written:
        assert os.path.dirname(path) == str(tmp_path)
        assert not os.path.abspath(path).startswith(tpu)
    assert [p.name for p in tmp_path.iterdir()] == [fresh.LIB_PATH.name]
    # a second binding finds it built and compiles nothing
    monkeypatch.setattr(native, "_LIB", None)
    assert fresh.get_lib() is not None and len(written) == 2


def test_a_failed_build_warns_once_and_runs_numpy(monkeypatch, tmp_path,
                                                  fresh):
    """A source g++ cannot compile: the first call warns with the
    compiler's error, later calls are silent, and rank and ref give the
    numpy path's results."""
    bad = tmp_path / "gf2core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setenv(_build.BUILD_DIR_ENV, str(tmp_path / "out"))
    A = (np.random.default_rng(5).random((20, 40)) < 0.3).astype(np.uint8)
    with pytest.warns(RuntimeWarning, match="(?s)g\\+\\+ failed .*error"):
        r = gf2.rank(A)
    assert fresh.get_lib() is None and "g++ failed" in fresh._FAILED
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = gf2.ref(A, reduced=True)
    _numpy_path(monkeypatch)
    assert r == gf2.rank(A)
    want = gf2.ref(A, reduced=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dense_dispatches_to_the_library(monkeypatch, lib):
    """`dense.rank` and `dense._eliminate_packed` reach the library: a
    counting stand-in for it sees both calls."""
    seen = []
    orig_rank, orig_elim = native.rank_native, native.eliminate_native
    monkeypatch.setattr(native, "rank_native",
                        lambda *a: seen.append("rank") or orig_rank(*a))
    monkeypatch.setattr(native, "eliminate_native",
                        lambda *a: seen.append("elim") or orig_elim(*a))
    A = np.eye(6, dtype=np.uint8)
    assert gf2.rank(A) == 6
    gf2.rref(A)
    assert seen == ["rank", "elim"]
