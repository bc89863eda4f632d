"""The port's general-H decoder (the plain version of kernel E, on CPU
tensors) against the reference's general-H Pallas kernel run in interpret
mode, as the JAX package's own tests run it, on non-QC matrices: the random
60 x 136 matrix of tests/test_general_h.py, a row-irregular one (row weights
3 to 8) and a column-permuted lp04_0 side (84 x 175, 588 edge slots).

MS under the layered schedule: e_hat, n_iter and converged equal and the
posterior equal by value on every element, tolerance 0 (the greedy
layerizer's layers share no variable, so every posterior entry receives one
delta per layer and the sum is exact; the reference's `new` feeds both the
stored message and `new - old`, so XLA:CPU contracts nothing there).

MS under flooding: a variable receives several deltas per iteration, which
the reference's one-hot product sums in an order of its own and the port in
ascending edge order: decisions equal on every shot of every case, the
posterior within the bound each case measured. BP cannot be bit-exact
(XLA:CPU's float32 tanh and log are its own polynomials): each case asserts
the agreement rates it measured (48 shots, numpy seed 5), each threshold
just under the measured value, and a bound on max |post - ref| /
max(|ref|, 1) over the shots where convergence, iteration count and
estimate all agree. Kernel E against this plain version on the card:
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import TannerGraph as RefGraph
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.ops.general_h_pallas import (
    _contiguous_layer_runs as ref_layer_runs,
)
from qldpcsim_tpu.ops.general_h_pallas import make_gh_decoder as ref_make
from qldpcsim_tpu.ops.general_h_pallas import supports as ref_supports

from qldpcsim_torch.convert import gh_tables_from_reference
from qldpcsim_torch.decoders import DecoderConfig, TannerGraph, build_layers
from qldpcsim_torch.decoders.common import LayerSchedule
from qldpcsim_torch.ops import general_h_cuda
from qldpcsim_torch.ops.qc import detect_qc

PRIOR = np.float32(0.05) / np.float32(3.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_ldpc(seed, m=60, n=136, rw=8, irregular=False):
    """tests/test_general_h.py's random matrix; `irregular` draws each row's
    weight from 3..rw."""
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.int8)
    for i in range(m):
        w = int(rng.integers(3, rw + 1)) if irregular else rw
        H[i, rng.choice(n, w, replace=False)] = 1
    return H


def _matrix(name):
    if name == "random":
        H = _random_ldpc(42)
    elif name == "irregular":
        H = _random_ldpc(42, irregular=True)
        assert len(set(H.sum(axis=1))) >= 4
    else:  # lp04_0's Hz with its columns permuted: no circulant lift left
        c = get_code("lp04_0")
        perm = np.random.default_rng(4).permutation(c.Hz.shape[1])
        H = (np.asarray(c.Hz) % 2)[:, perm].astype(np.int8)
        assert H.shape == (84, 175) and H.shape[0] * H.sum(axis=1).max() == 588
    assert detect_qc(H) is None
    return H


def _syndromes(seed, H, n_shots, p):
    rng = np.random.default_rng(seed)
    errs = (rng.random((n_shots, H.shape[1])) < p).astype(np.int64)
    return ((errs @ H.T.astype(np.int64)) % 2).astype(np.int8)


_BUILT = {}


def _both(name, kind, sched, max_iter, B_blk=16):
    key = (name, kind, sched, max_iter, B_blk)
    if key not in _BUILT:
        H = _matrix(name)
        ref = ref_make(H, RefConfig(dec_type=kind, max_iter=max_iter,
                                    schedule=sched),
                       layers=ref_build_layers(H, sched), B_blk=B_blk,
                       interpret=True, kind=kind)
        port = general_h_cuda.make_gh_decoder(
            H, DecoderConfig(dec_type=kind, max_iter=max_iter,
                             schedule=sched),
            layers=build_layers(H, sched), kind=kind)
        _BUILT[key] = (H, ref, port)
    return _BUILT[key]


def _assert_equal(r, o):
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    # by value, tolerance 0 (== takes -0.0 and 0.0 as equal)
    assert (np.asarray(r.posterior) == o.posterior.numpy()).all()
    assert o.e_hat.dtype == torch.int8 and o.n_iter.dtype == torch.int32
    assert o.converged.dtype == torch.bool


@pytest.mark.parametrize("name,max_iter,n_shots", [
    ("random", 12, 48), ("irregular", 12, 48), ("lp04_perm", 12, 48),
    ("lp04_perm", 30, 48),
    ("random", 10, 40),      # several reference blocks and a partial one
    ("lp04_perm", 12, 1), ("irregular", 12, 63),
])
def test_ms_layered_plain_equals_pallas_interpret(name, max_iter, n_shots):
    H, ref, port = _both(name, "MS", "L", max_iter)
    assert not port.tabs.run_shared.any() and len(port.tabs.runs) > 1
    syn = _syndromes(5, H, n_shots, 0.03)
    r, o = ref(syn, PRIOR), port(torch.from_numpy(syn), PRIOR)
    _assert_equal(r, o)
    assert o.posterior.shape == (n_shots, H.shape[1])
    if n_shots > 1:  # the case decodes: several iteration counts
        assert len(np.unique(o.n_iter.numpy())) >= 3 and o.converged.any()
    est = (o.e_hat.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    conv = o.converged.numpy()
    assert np.array_equal(est[conv], syn[conv])


# name -> bound on |post - ref| / max(|ref|, 1); measured 6.9e-6 (random),
# 6.7e-7 (irregular), 1.2e-5 and 6.6e-5 (lp04_perm at 12 and 30 iterations)
MS_F_CASES = {("random", 12): 2e-5, ("irregular", 12): 3e-6,
              ("lp04_perm", 12): 4e-5, ("lp04_perm", 30): 2e-4}


@pytest.mark.parametrize("case", sorted(MS_F_CASES), ids=lambda c: "-".join(
    map(str, c)))
def test_ms_flooding_plain_agrees_with_pallas_interpret(case):
    name, max_iter = case
    H, ref, port = _both(name, "MS", "F", max_iter)
    assert port.tabs.runs == [(0, H.shape[0])] and port.tabs.run_shared.all()
    syn = _syndromes(5, H, 48, 0.03)
    r, o = ref(syn, PRIOR), port(torch.from_numpy(syn), PRIOR)
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    rp, op = np.asarray(r.posterior), o.posterior.numpy()
    rel = np.abs(rp - op) / np.maximum(np.abs(rp), 1.0)
    assert rel.max() <= MS_F_CASES[case]
    assert len(np.unique(o.n_iter.numpy())) >= 3 and o.converged.any()


# (name, schedule): thresholds on the agreement of converged, n_iter and
# e_hat, and the bound on the posterior over agreeing shots. Measured
# (converged, n_iter, e_hat, bound): random L 1, 1, 0.917, 0.0161; random F
# 1, 1, 0.979, 0.0225; irregular L 1, 1, 1, 0.0100; irregular F 1, 1, 1,
# 0.0099; lp04_perm L 1, 1, 1, 0.573 (one shot that never converges);
# lp04_perm F 1, 1, 1, 0.0267
BP_CASES = {
    ("random", "L"): ((0.97, 0.97, 0.9), 0.03),
    ("random", "F"): ((0.97, 0.97, 0.95), 0.05),
    ("irregular", "L"): ((0.97, 0.97, 0.97), 0.03),
    ("irregular", "F"): ((0.97, 0.97, 0.97), 0.03),
    ("lp04_perm", "L"): ((0.97, 0.97, 0.97), 1.2),
    ("lp04_perm", "F"): ((0.97, 0.97, 0.97), 0.06),
}


@pytest.mark.parametrize("case", sorted(BP_CASES), ids=lambda c: "-".join(c))
def test_bp_plain_agrees_with_pallas_interpret(case):
    name, sched = case
    (t_conv, t_iter, t_ehat), bound = BP_CASES[case]
    H, ref, port = _both(name, "BP", sched, 12)
    syn = _syndromes(5, H, 48, 0.03)
    r, o = ref(syn, PRIOR), port(torch.from_numpy(syn), PRIOR)
    rc, oc = np.asarray(r.converged), o.converged.numpy()
    ri, oi = np.asarray(r.n_iter), o.n_iter.numpy()
    same_e = (np.asarray(r.e_hat) == o.e_hat.numpy()).all(axis=1)
    assert (rc == oc).mean() >= t_conv
    assert (ri == oi).mean() >= t_iter
    assert same_e.mean() >= t_ehat
    agree = (rc == oc) & (ri == oi) & same_e
    rp, op = np.asarray(r.posterior), o.posterior.numpy()
    rel = np.abs(rp - op) / np.maximum(np.abs(rp), 1.0)
    assert np.isfinite(op).all() and rel[agree].max() <= bound
    assert oc.any() and len(np.unique(oi)) >= 3
    est = (o.e_hat.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    assert np.array_equal(est[oc], syn[oc])


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_zero_syndrome_and_frozen_shots(kind):
    """A zero syndrome runs one iteration (n_iter == 1) and decodes to 0; a
    converged shot keeps the state of the iteration at which it latched,
    whatever the cap and whoever shares its batch."""
    H, ref, port = _both("lp04_perm", kind, "L", 12)
    zero = np.zeros((4, H.shape[0]), np.int8)
    r, o = ref(zero, 0.01), port(torch.from_numpy(zero), 0.01)
    assert o.converged.all() and (o.n_iter == 1).all() and not o.e_hat.any()
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    syn = _syndromes(5, H, 48, 0.03)
    o12 = port(torch.from_numpy(syn), PRIOR)
    deep = general_h_cuda.make_gh_decoder(
        H, DecoderConfig(dec_type=kind, max_iter=30, schedule="L"),
        layers=build_layers(H, "L"), kind=kind)
    o30 = deep(torch.from_numpy(syn), PRIOR)
    conv = o12.converged.numpy()
    assert conv.sum() >= 5
    for name in ("e_hat", "n_iter", "converged", "posterior"):
        assert torch.equal(getattr(o12, name)[conv], getattr(o30, name)[conv])
    first = int(np.nonzero(conv & (o12.n_iter.numpy() >= 2))[0][0])
    alone = port(torch.from_numpy(syn[first:first + 1]), PRIOR)
    assert torch.equal(alone.posterior[0], o12.posterior[first])
    assert int(alone.n_iter[0]) == int(o12.n_iter[first])


def test_supports_and_layer_runs():
    H = _matrix("random")
    m = H.shape[0]
    cases = {
        "none": None,
        "flooding": build_layers(H, "F"),
        "layered": build_layers(H, "L"),
        "serial": build_layers(H, "S"),
        "reversed": LayerSchedule.from_layers(
            [np.array([r]) for r in reversed(range(m))], m),
        "short": LayerSchedule.from_layers([np.arange(m - 1)], m),
        "gap": LayerSchedule.from_layers(
            [np.array([0, 2]), np.array([1])] + [np.arange(3, m)], m),
        "with an empty layer": LayerSchedule.from_layers(
            [np.arange(0, 5), np.array([], dtype=np.int32),
             np.arange(5, m)], m),
    }
    for name, layers in cases.items():
        got = general_h_cuda._contiguous_layer_runs(layers, m)
        assert got == ref_layer_runs(layers, m), name
        assert general_h_cuda.supports(H, layers) == ref_supports(H, layers)
    assert general_h_cuda._contiguous_layer_runs(None, m) == [(0, m)]
    assert general_h_cuda.supports(H, cases["with an empty layer"])
    for bad in ("reversed", "short", "gap"):
        assert not general_h_cuda.supports(H, cases[bad])
        with pytest.raises(ValueError):
            general_h_cuda.make_gh_decoder(H, DecoderConfig(schedule="L"),
                                           layers=cases[bad])
    assert not general_h_cuda.supports(np.zeros((3, 5), np.int8), None)
    with pytest.raises(ValueError):
        general_h_cuda.make_gh_decoder(np.zeros((3, 5), np.int8),
                                       DecoderConfig())
    with pytest.raises(ValueError):
        general_h_cuda.make_gh_decoder(H, DecoderConfig(schedule="S"),
                                       layers=cases["serial"])
    with pytest.raises(ValueError):
        general_h_cuda.make_gh_decoder(H, DecoderConfig(), kind="BF")
    # the flooding schedule is one run whatever the layers say
    dec = general_h_cuda.make_gh_decoder(H, DecoderConfig(schedule="F"),
                                         layers=cases["layered"])
    assert dec.tabs.runs == [(0, m)]


@pytest.mark.parametrize("name", ["random", "irregular", "lp04_perm"])
@pytest.mark.parametrize("sched", ["F", "L"])
def test_tables_from_reference_graph(name, sched):
    """`gh_tables_from_reference` gives, from the JAX package's TannerGraph
    and LayerSchedule and from the port's own, the tables the decoder
    builds for H, and they describe H."""
    H = _matrix(name)
    own = general_h_cuda.make_gh_decoder(
        H, DecoderConfig(schedule=sched), layers=build_layers(H, sched)).tabs
    for graph, layers in ((RefGraph.build(H), ref_build_layers(H, sched)),
                          (TannerGraph.build(H), build_layers(H, sched))):
        t = gh_tables_from_reference(graph, layers)
        for f in ("n", "var_of", "run_ptr", "run_shared"):
            assert np.array_equal(getattr(t, f), getattr(own, f)), f
        assert t.var_of.dtype == np.int32 and t.run_ptr.dtype == np.int32
    assert (own.m, own.n) == H.shape and own.dmax == H.sum(axis=1).max()
    assert own.n_edges == H.shape[0] * own.dmax
    rebuilt = np.zeros_like(H)
    for i in range(own.m):
        vs = own.var_of[i][own.var_of[i] >= 0]
        assert (np.diff(vs) > 0).all()
        rebuilt[i, vs] = 1
    assert np.array_equal(rebuilt, H)
    assert own.runs == ref_layer_runs(ref_build_layers(H, sched), H.shape[0])
    # rows of a greedy layer share no variable; the flooding run does
    assert own.run_shared.tolist() == [int(sched == "F")] * len(own.runs)
    with pytest.raises(ValueError):
        gh_tables_from_reference(TannerGraph.build(H), LayerSchedule
                                 .from_layers([np.arange(1, H.shape[0])],
                                              H.shape[0]))


def test_scratch_is_kept_and_grown():
    """The device-memory state of kernel E: (B, state_words) float32, one
    buffer per decoder, grown to the largest batch seen."""
    H = _matrix("random")
    dec = general_h_cuda.make_gh_decoder(H, DecoderConfig(schedule="L"),
                                         layers=build_layers(H, "L"))
    words = 136 + 60 * 8 + 60      # posterior, messages, syndrome signs
    assert dec.state_words == words and dec.delta_edges == 0
    s1 = dec.scratch(64, torch.device("cpu"))
    s2 = dec.scratch(32, torch.device("cpu"))
    assert s1.shape == (64, words) and s1.dtype == torch.float32
    assert s2.data_ptr() == s1.data_ptr() and s2.shape == (32, words)
    s3 = dec.scratch(128, torch.device("cpu"))
    assert s3.shape == (128, words) and s3.is_contiguous()
    flood = general_h_cuda.make_gh_decoder(H, DecoderConfig(schedule="F"))
    # flooding adds the deltas of its one layer, all 480 edge slots
    assert flood.delta_edges == 480
    assert flood.scratch(16, torch.device("cpu")).shape == (16, words + 480)


def _decision_matrix(name):
    """The matrices of the build-time decision cases: the library's small
    codes, a random matrix with rows of 33 to 40 slots (`wide`), and one
    whose per-shot state exceeds a block's shared memory (`oversize`: 3000
    x 6000, rows of 18 to 20 slots)."""
    if name in ("random", "irregular", "lp04_perm"):
        return _matrix(name)
    if name in ("bicycle", "steane"):
        return np.asarray(get_code(name).Hz) % 2
    if name in ("shor_z", "shor_x"):
        c = get_code("shor")
        return np.asarray(c.Hz if name == "shor_z" else c.Hx) % 2
    m, n, lo, hi, seed = ((12, 200, 33, 40, 3) if name == "wide"
                          else (3000, 6000, 18, 20, 5))
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.int8)
    for i in range(m):
        H[i, rng.choice(n, int(rng.integers(lo, hi + 1)), replace=False)] = 1
    return H


# (matrix, schedule) -> (per_edge, threads, state_on_device, smem_bytes)
DECISIONS = {
    ("lp04_perm", "L"): (True, 128, False, 5816),    # 14-row layers, 8 lanes
    ("lp04_perm", "F"): (False, 96, False, 11160),   # 84 rows side by side
    ("bicycle", "L"): (True, 32, False, 11976),      # one-row layers, a warp
    ("bicycle", "F"): (False, 96, False, 22500),
    ("steane", "L"): (True, 32, False, 164),
    ("steane", "F"): (True, 32, False, 276),
    ("shor_z", "L"): (True, 32, False, 192),
    ("shor_x", "F"): (True, 32, False, 288),
    ("irregular", "L"): (True, 64, False, 4820),
    ("irregular", "F"): (True, 256, False, 8456),    # 60 rows x 8 lanes
    ("wide", "L"): (False, 32, False, 4788),         # dmax 40: a row each
    ("wide", "F"): (False, 32, False, 9204),
    ("oversize", "L"): (True, 256, True, 0),         # state and tables in
    ("oversize", "F"): (False, 256, True, 0),        # device memory
}


@pytest.mark.parametrize("case", sorted(DECISIONS), ids=lambda c: "-".join(c))
def test_kernel_decisions_from_tables(case):
    """`per_edge`, `threads`, `state_on_device` and `smem_bytes` of kernel E,
    fixed from the tables when the decoder is built."""
    name, sched = case
    H = _decision_matrix(name)
    dec = general_h_cuda.make_gh_decoder(H, DecoderConfig(schedule=sched),
                                         layers=build_layers(H, sched))
    t = dec.tabs
    got = (dec.per_edge, dec.threads, dec.state_on_device, dec.smem_bytes)
    assert got == DECISIONS[case]
    shared = [b - a for (a, b), s in zip(t.runs, t.run_shared) if s]
    assert dec.delta_edges == max(shared, default=0) * t.dmax
    assert dec.state_words == t.n + t.n_edges + dec.delta_edges + t.m
    assert dec.state_on_device == (4 * dec.state_words > 232448)
    assert dec.lanes >= t.dmax or not dec.per_edge
    assert dec.threads % 32 == 0 and 32 <= dec.threads <= 256
    if dec.per_edge:
        assert dec.lanes in (2, 4, 8, 16, 32) and dec.lanes < 2 * t.dmax + 2
        assert dec.threads % dec.lanes == 0
    if not dec.state_on_device:
        assert dec.smem_bytes >= 4 * dec.state_words
        assert dec.tables_in_shared == (dec.smem_bytes
                                        > 4 * dec.state_words)
    # forcing the state into device memory leaves the tables (where they
    # fit) as the block's only shared memory
    dec.state_on_device = True
    assert dec.smem_bytes == (4 * dec.table_words if dec.tables_in_shared
                              else 0)
    assert dec.smem_bytes <= 232448


@pytest.mark.parametrize("name,sched", [
    ("lp04_perm", "F"), ("bicycle", "F"), ("steane", "F"), ("shor_x", "F"),
    ("irregular", "L")])
def test_column_table_lists_each_shared_edge_once(name, sched):
    """`GHTables.col_edges()`: within every layer whose rows share a
    variable, each edge appears exactly once, under its own variable, in
    ascending order; the edges outside the layer are those outside its
    slot range. Caller layers of two rows each make the `irregular` case's
    runs shared."""
    H = _decision_matrix(name)
    m = H.shape[0]
    layers = build_layers(H, sched)
    if name == "irregular":
        layers = LayerSchedule.from_layers(
            [np.arange(i, min(i + 2, m)) for i in range(0, m, 2)], m)
    dec = general_h_cuda.make_gh_decoder(H, DecoderConfig(schedule=sched),
                                         layers=layers)
    t = dec.tabs
    assert t.run_shared.any()
    col_ptr, col_edge = t.col_edges()
    assert np.array_equal(dec.col_ptr.numpy(), col_ptr)
    assert np.array_equal(dec.col_edge.numpy(), col_edge)
    flat = t.var_of.reshape(-1)
    assert col_ptr[0] == 0 and col_ptr[-1] == col_edge.size == (flat >= 0).sum()
    assert np.array_equal(np.diff(col_ptr), H.sum(axis=0))
    for (a, b), s in zip(t.runs, t.run_shared):
        if not s:
            continue
        seen = []
        for v in range(t.n):
            es = col_edge[col_ptr[v]:col_ptr[v + 1]]
            es = es[(es >= a * t.dmax) & (es < b * t.dmax)]
            assert (np.diff(es) > 0).all() and (flat[es] == v).all()
            seen.extend(es.tolist())
        run = np.arange(a * t.dmax, b * t.dmax)
        assert sorted(seen) == run[flat[run] >= 0].tolist()


def test_ctypes_signature_matches_the_source():
    """The wrapper's argtypes for `general_h_decode` follow the C signature
    in csrc/general_h.cu, type by type (a count that differs is only caught
    on the card, where the call raises)."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(general_h_cuda.__file__).parent.parent / "csrc"
           / "general_h.cu").read_text()
    sig = re.search(r"int general_h_decode\(([^)]*)\)", src).group(1)
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
            for p in (q.strip() for q in sig.split(","))]
    assert general_h_cuda.ARGTYPES == want


def test_other_devices_raise():
    H = _matrix("random")
    dec = general_h_cuda.make_gh_decoder(H, DecoderConfig(schedule="F"))
    with pytest.raises(ValueError):
        general_h_cuda.general_h(dec, torch.zeros(60, 8, device="meta"), 1.0)
    with pytest.raises(ValueError):     # wrong row count
        general_h_cuda.general_h_cuda(dec, torch.zeros(61, 8), 1.0)
    with pytest.raises(ValueError):     # not contiguous
        general_h_cuda.general_h_cuda(dec, torch.zeros(8, 60).T, 1.0)
