"""The port's serial (row-sequential) QC decoder (the plain version of
kernel D, on CPU tensors) against the reference's Pallas serial kernel run
in interpret mode, as the JAX package's own tests run it.

MS: e_hat, n_iter and converged equal and the posterior equal by value on
every element: tolerance 0. That holds because the plain version forms
`new - old` as one fused multiply-add, as XLA:CPU contracts it when it
compiles the reference kernel (with a separate multiply and subtract the
posteriors differ by 1 ulp from the second iteration on).

BP cannot be bit-exact: XLA:CPU evaluates float32 tanh and log with its own
polynomials, torch with others (ROADMAP queue 3, "BP transcendentals").
Each BP case asserts the agreement rates it measured (32 shots, numpy seed
5, bit-flip rate 0.03, prior 0.05/3), each threshold just under the
measured value, and a bound on max |post - ref| / max(|ref|, 1) over the
shots where convergence, iteration count and estimate all agree. Kernel D
against this plain version on the card: tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.ops.qc import detect_qc as ref_detect_qc
from qldpcsim_tpu.ops.seq_qc_pallas import make_seq_qc_decoder as ref_make
from qldpcsim_tpu.ops.seq_qc_pallas import (
    serial_order_is_natural as ref_order_is_natural,
)

from qldpcsim_torch.convert import seq_qc_tables_from_reference
from qldpcsim_torch.decoders import DecoderConfig, build_layers
from qldpcsim_torch.decoders.common import LayerSchedule
from qldpcsim_torch.ops import seq_qc_cuda
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


def _syndromes(seed, H, n_shots, p):
    rng = np.random.default_rng(seed)
    errs = (rng.random((n_shots, H.shape[1])) < p).astype(np.int64)
    return ((errs @ H.T.astype(np.int64)) % 2).astype(np.int8)


_BUILT = {}


def _both(code, kind, max_iter):
    """(H, reference decoder, port decoder); the reference's interpret-mode
    kernel takes ~20 s to compile, so each is built once per module."""
    key = (code, kind, max_iter)
    if key not in _BUILT:
        H = np.asarray(get_code(code).Hz) % 2
        # the reference's QCStructure feeds both packages' tables
        st = ref_detect_qc(H)
        ref = ref_make(st, RefConfig(dec_type=kind, max_iter=max_iter,
                                     schedule="S"),
                       layers=ref_build_layers(H, "S"), B_blk=32,
                       interpret=True, kind=kind)
        port = seq_qc_cuda.make_seq_qc_decoder(
            st, DecoderConfig(dec_type=kind, max_iter=max_iter,
                              schedule="S"),
            layers=build_layers(H, "S"), kind=kind)
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


@pytest.mark.parametrize("code,max_iter,n_shots,p_err", [
    ("lp04_0", 6, 32, 0.03),
    ("lp04_0", 30, 32, 0.03),
    ("tanner", 3, 32, 0.02),
])
def test_ms_plain_equals_pallas_interpret(code, max_iter, n_shots, p_err):
    H, ref, port = _both(code, "MS", max_iter)
    syn = _syndromes(5, H, n_shots, p_err)
    r, o = ref(syn, PRIOR), port(torch.from_numpy(syn), PRIOR)
    _assert_equal(r, o)
    assert o.posterior.shape == (n_shots, H.shape[1])
    # the case decodes: several iteration counts, not all shots at the cap
    assert len(np.unique(o.n_iter.numpy())) >= 3
    assert o.converged.any()


# (code, max_iter): measured agreement of converged, n_iter and e_hat, and
# the measured posterior bound -> (thresholds, bound) asserted
BP_CASES = {
    # measured: 1.0, 1.0, 1.0, 0.0178
    ("lp04_0", 6): ((0.96, 0.96, 0.96), 0.02),
    # measured: 0.969, 0.969, 0.969 (one shot of 32: 26 against 30
    # iterations), 0.0145
    ("lp04_0", 30): ((0.96, 0.96, 0.96), 0.02),
}


@pytest.mark.parametrize("case", sorted(BP_CASES), ids=lambda c: "-".join(
    map(str, c)))
def test_bp_plain_agrees_with_pallas_interpret(case):
    code, max_iter = case
    (t_conv, t_iter, t_ehat), bound = BP_CASES[case]
    H, ref, port = _both(code, "BP", max_iter)
    syn = _syndromes(5, H, 32, 0.03)
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
    assert rel[agree].max() <= bound
    assert oc.any() and len(np.unique(oi)) >= 3


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_zero_syndrome_latches_after_row_0(kind):
    """W is 0 before any update, but the test follows row 0's update:
    n_iter == 1, e_hat == 0, exactly as the reference."""
    H, ref, port = _both("lp04_0", kind, 6)
    syn = np.zeros((8, H.shape[0]), np.int8)
    r, o = ref(syn, 0.01), port(torch.from_numpy(syn), 0.01)
    _assert_equal(r, o)
    assert o.converged.all() and (o.n_iter == 1).all()
    assert not o.e_hat.any()


def test_latch_mid_iteration_freezes_the_shot():
    """A shot that latches at some row of iteration k keeps the state it had
    after that row: decoding it at a larger iteration cap, or beside other
    shots, changes nothing, and its estimate reproduces the syndrome."""
    H, ref, port = _both("lp04_0", "MS", 6)
    H30, ref30, port30 = _both("lp04_0", "MS", 30)
    syn = _syndromes(5, H, 32, 0.03)
    o6 = port(torch.from_numpy(syn), PRIOR)
    o30 = port30(torch.from_numpy(syn), PRIOR)
    mid = (o6.converged & (o6.n_iter >= 2)).numpy()
    assert mid.sum() >= 5
    for name in ("e_hat", "n_iter", "converged", "posterior"):
        assert torch.equal(getattr(o6, name)[mid], getattr(o30, name)[mid])
    alone = port(torch.from_numpy(syn[mid][:1]), PRIOR)
    first = int(np.nonzero(mid)[0][0])
    assert torch.equal(alone.posterior[0], o6.posterior[first])
    assert int(alone.n_iter[0]) == int(o6.n_iter[first])
    est = (o6.e_hat.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    assert np.array_equal(est[o6.converged.numpy()],
                          syn[o6.converged.numpy()])
    # the others ran to the cap
    unconv = ~o6.converged.numpy()
    assert unconv.any() and (o6.n_iter.numpy()[unconv] == 6).all()


def test_serial_order_is_natural():
    H = np.asarray(get_code("lp04_0").Hz) % 2
    m = H.shape[0]
    cases = {
        "serial": build_layers(H, "S"),
        "layered": build_layers(H, "L"),
        "flooding": build_layers(H, "F"),
        "reversed": LayerSchedule.from_layers(
            [np.array([r]) for r in reversed(range(m))], m),
        "short": LayerSchedule.from_layers(
            [np.array([r]) for r in range(m - 1)], m),
        "with an empty layer": LayerSchedule.from_layers(
            [np.array([0]), np.array([], dtype=np.int32)]
            + [np.array([r]) for r in range(1, m)], m),
    }
    for name, layers in cases.items():
        got = seq_qc_cuda.serial_order_is_natural(layers, m)
        assert got == ref_order_is_natural(layers, m), name
    assert seq_qc_cuda.serial_order_is_natural(cases["serial"], m)
    assert seq_qc_cuda.serial_order_is_natural(cases["with an empty layer"], m)
    assert not seq_qc_cuda.serial_order_is_natural(cases["reversed"], m)
    assert not seq_qc_cuda.serial_order_is_natural(None, m)
    st = detect_qc(H)
    with pytest.raises(ValueError):
        seq_qc_cuda.make_seq_qc_decoder(st, DecoderConfig(schedule="S"),
                                        layers=cases["reversed"])
    with pytest.raises(ValueError):
        seq_qc_cuda.make_seq_qc_decoder(st, DecoderConfig(), kind="BF")


@pytest.mark.parametrize("code", ["lp04_0", "tanner", "lp118_0"])
def test_tables_from_reference_structure(code):
    """`seq_qc_tables_from_reference` gives the same tables from the JAX
    package's QCStructure and from the port's own, and they describe H."""
    H = np.asarray(get_code(code).Hz) % 2
    a = seq_qc_tables_from_reference(ref_detect_qc(H))
    b = seq_qc_tables_from_reference(detect_qc(H))
    for f in ("L", "n_b", "row_ptr", "slot_j", "slot_s", "group_ptr",
              "group_snap", "col_ptr", "col_i", "col_s", "row_par"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    L = a.L
    assert (a.m, a.n) == H.shape and a.n_slots * L == int(H.sum())
    rebuilt = np.zeros_like(H)
    for j in range(a.n_b):
        for k in range(int(a.col_ptr[j]), int(a.col_ptr[j + 1])):
            v = np.arange(L)
            rebuilt[a.col_i[k] * L + (v - a.col_s[k]) % L, j * L + v] = 1
    assert np.array_equal(rebuilt, H)
    assert np.array_equal(np.repeat(a.row_par, L), H.sum(axis=1) % 2)


def test_scratch_is_kept_and_grown():
    H = np.asarray(get_code("lp04_0").Hz) % 2
    dec = seq_qc_cuda.make_seq_qc_decoder(detect_qc(H), DecoderConfig())
    c1, m1 = dec.scratch(64, torch.device("cpu"))
    c2, m2 = dec.scratch(32, torch.device("cpu"))
    assert c1.shape == (int(H.sum()), 64) and m1.shape == (H.shape[0], 64)
    assert c2.data_ptr() == c1.data_ptr() and m2.data_ptr() == m1.data_ptr()
    c3, _ = dec.scratch(128, torch.device("cpu"))
    assert c3.shape == (int(H.sum()), 128)
    assert m1.dtype == torch.uint8 and c1.dtype == torch.float32
