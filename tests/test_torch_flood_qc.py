"""The port's slot-stacked flooding decoder (kernel F's plain version on CPU
tensors) against the reference's stacked Pallas kernel in interpret mode
(`QLDPC_QC_STACKED=1`, read when the reference decoder is built).

MS is bit-exact, posterior included: the same float32 operations in the
same association (pairwise min tree, deltas summed per variable block, then
added once). BP is held to measured agreement rates, as in
tests/test_torch_bp_qc.py (XLA:CPU's tanh and log are its own polynomials):
64 shots, numpy seed 11, p = 0.06, prior 0.05/3, each threshold just under
what was measured, and a bound on max |post - ref| / max(|ref|, 1) over the
shots where convergence, iteration count and estimate all agree. Kernel F
against this plain version on the card: tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.ops.ms_qc_pallas import make_qc_decoder as ref_make
from qldpcsim_tpu.ops.qc import QCStructure, detect_qc

from qldpcsim_torch.convert import qc_tables_from_reference
from qldpcsim_torch.decoders import DecoderConfig, build_layers
from qldpcsim_torch.ops import flood_qc_cuda, ms_qc_cuda


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


def _both(code, side, kind, max_iter, monkeypatch):
    H = np.asarray(getattr(get_code(code), side)) % 2
    st = detect_qc(H)
    monkeypatch.setenv("QLDPC_QC_STACKED", "1")
    ref = ref_make(st, RefConfig(dec_type=kind, max_iter=max_iter,
                                 schedule="F"), B_blk=32, interpret=True,
                   kind=kind)
    monkeypatch.delenv("QLDPC_QC_STACKED")
    port = ms_qc_cuda.make_qc_decoder(
        st, DecoderConfig(dec_type=kind, max_iter=max_iter, schedule="F"),
        stacked=True)
    assert port.stacked
    return H, ref, port


@pytest.mark.parametrize("code,side", [("lp04_0", "Hz"), ("lp04_0", "Hx"),
                                       ("lp118_0", "Hz")])
@pytest.mark.parametrize("max_iter", [6, 30])
def test_ms_plain_equals_stacked_pallas_interpret(code, side, max_iter,
                                                  monkeypatch):
    """d = 7 on lp04_0 (the odd branch of the tree), 8 on lp118_0."""
    H, ref, port = _both(code, side, "MS", max_iter, monkeypatch)
    syn = _syndromes(5, H, 40, 0.05)
    p = np.float32(0.05) / np.float32(3.0)
    r, o = ref(syn, p), port(torch.from_numpy(syn), p)
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    # bit-exact posterior, also for shots that ran every iteration
    assert np.array_equal(np.asarray(r.posterior), o.posterior.numpy())
    conv = np.asarray(r.converged)
    assert conv.any() and not conv.all()
    assert (np.asarray(r.n_iter) >= 2).any()


# (code, side, max_iter): measured agreement of converged, n_iter and e_hat,
# and the measured posterior bound -> (thresholds, bound) asserted
BP_CASES = {
    # measured: 1.0, 1.0, 1.0, 0.0377
    ("lp04_0", "Hz", 8): ((0.98, 0.98, 0.98), 0.045),
    # measured: 1.0, 1.0, 0.953, 0.367
    ("lp04_0", "Hx", 30): ((0.98, 0.98, 0.93), 0.4),
    # measured: 1.0, 1.0, 1.0, 0.0311
    ("lp118_0", "Hz", 8): ((0.98, 0.98, 0.98), 0.04),
    # measured: 1.0, 1.0, 0.922, 2.02 (shots that ran all 30 iterations)
    ("lp118_0", "Hz", 30): ((0.98, 0.98, 0.9), 2.2),
}


@pytest.mark.parametrize("case", sorted(BP_CASES), ids=lambda c: "-".join(
    map(str, c)))
def test_bp_plain_agrees_with_stacked_pallas_interpret(case, monkeypatch):
    code, side, max_iter = case
    (t_conv, t_iter, t_ehat), bound = BP_CASES[case]
    H, ref, port = _both(code, side, "BP", max_iter, monkeypatch)
    syn = _syndromes(11, H, 64, 0.06)
    p = np.float32(0.05) / np.float32(3.0)
    r, o = ref(syn, p), port(torch.from_numpy(syn), p)
    rc, oc = np.asarray(r.converged), o.converged.numpy()
    ri, oi = np.asarray(r.n_iter), o.n_iter.numpy()
    same_e = (np.asarray(r.e_hat) == o.e_hat.numpy()).all(axis=1)
    agree = (rc == oc) & (ri == oi) & same_e
    rp, op = np.asarray(r.posterior), o.posterior.numpy()
    rel = np.abs(rp - op) / np.maximum(np.abs(rp), 1.0)
    assert (rc == oc).mean() >= t_conv
    assert (ri == oi).mean() >= t_iter
    assert same_e.mean() >= t_ehat
    assert rel[agree].max() <= bound
    assert rc.any() and not rc.all()


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_zero_syndrome_is_exact(kind, monkeypatch):
    H, ref, port = _both("lp04_0", "Hz", kind, 5, monkeypatch)
    syn = np.zeros((8, H.shape[0]), np.int8)
    r, o = ref(syn, 0.01), port(torch.from_numpy(syn), 0.01)
    assert np.array_equal(np.asarray(r.posterior), o.posterior.numpy())
    assert o.converged.all() and (o.n_iter == 1).all()
    assert not o.e_hat.any()


def test_stacked_and_per_slot_decide_alike_under_ms():
    """The two kernels' plain versions on the same syndromes: decisions,
    iteration counts and convergence equal; the posterior differs in its
    last bits (deltas summed first against added one by one)."""
    H = np.asarray(get_code("lp04_0").Hz) % 2
    st = detect_qc(H)
    cfg = DecoderConfig(dec_type="MS", max_iter=10, schedule="F")
    syn = torch.from_numpy(_syndromes(3, H, 32, 0.04))
    a = ms_qc_cuda.make_qc_decoder(st, cfg, stacked=True)(syn, 0.01)
    b = ms_qc_cuda.make_qc_decoder(st, cfg, stacked=False)(syn, 0.01)
    assert torch.equal(a.e_hat, b.e_hat)
    assert torch.equal(a.n_iter, b.n_iter)
    assert torch.equal(a.converged, b.converged)
    diff = (a.posterior - b.posterior).abs().max()
    assert 0.0 < float(diff) < 1e-3


def _irregular_structure():
    """Two block-rows of degrees 2 and 1 over three variable blocks."""
    return QCStructure(L=4, shifts=np.array([[1, 0, -1], [-1, -1, 3]]))


def test_selection_rules(monkeypatch):
    """Kernel F is taken under F with one check per iteration, a uniform
    block-row degree and the opt-in (keyword, or the environment when the
    decoder is built); kernel B otherwise."""
    H = np.asarray(get_code("lp04_0").Hz) % 2
    st = detect_qc(H)
    layers = build_layers(H, "L")

    def stacked(sched="F", chk="iter", st_=st, **kw):
        return ms_qc_cuda.make_qc_decoder(
            st_, DecoderConfig(schedule=sched, qc_check_every=chk),
            layers=layers if sched == "L" and st_ is st else None,
            **kw).stacked

    assert flood_qc_cuda.uniform_degree(st) == 7
    monkeypatch.delenv("QLDPC_QC_STACKED", raising=False)
    assert not stacked()                      # the default is off
    assert stacked(stacked=True)
    assert not stacked(sched="L", stacked=True)
    assert not stacked(chk="layer", stacked=True)
    monkeypatch.setenv("QLDPC_QC_STACKED", "1")
    assert stacked()                          # read when the decoder is built
    assert not stacked(stacked=False)         # the keyword wins
    assert not stacked(sched="L")
    monkeypatch.setenv("QLDPC_QC_STACKED", "0")
    assert not stacked()


def test_non_uniform_degree_takes_the_per_slot_kernel():
    st = _irregular_structure()
    assert flood_qc_cuda.uniform_degree(st) is None
    dec = ms_qc_cuda.make_qc_decoder(st, DecoderConfig(schedule="F"),
                                     stacked=True)
    assert not dec.stacked
    out = dec(torch.zeros((2, st.m), dtype=torch.int8), 0.01)
    assert out.converged.all()


def test_column_view_and_kernel_limits():
    H = np.asarray(get_code("lp118_0").Hz) % 2
    st = detect_qc(H)
    t = qc_tables_from_reference(st, [list(range(st.m_b))])
    col_ptr, col_k = t.col_slots()
    assert col_ptr[-1] == t.n_slots == 120
    for j in range(t.n_b):
        ks = col_k[col_ptr[j]:col_ptr[j + 1]]
        assert list(ks) == sorted(ks) and (t.slot_j[ks] == j).all()
    tabs = flood_qc_cuda.stacked_tables(t)
    # every (slot, check row) delta goes back to the variable it was read from
    flat = np.arange(t.n_slots * t.L)
    for c in range(tabs["back_idx"].shape[0]):
        has = tabs["back_mask"][c]
        assert (tabs["gidx"][tabs["back_idx"][c][has]]
                == np.arange(t.n)[has]).all()
    assert sorted(np.concatenate([
        tabs["back_idx"][c][tabs["back_mask"][c]]
        for c in range(tabs["back_idx"].shape[0])])) == list(flat)
    # one shot's state on lp118_0: (544 + 2 * 1920 + 240) floats and tables
    assert flood_qc_cuda.smem_bytes(t) == 4 * (544 + 3840 + 240) + 4 * 395
    dec = ms_qc_cuda.make_qc_decoder(st, DecoderConfig(schedule="F"),
                                     stacked=True)
    with pytest.raises(ValueError, match="float32"):
        flood_qc_cuda.flood_qc_cuda(dec, torch.zeros((4, t.m)).double(), 1.0)


@pytest.mark.parametrize("limit", ["degree", "shared memory"])
def test_code_beyond_kernel_f_limits_goes_to_the_per_slot_kernel(limit):
    """Kernel F is built for block-row degrees up to 16 and needs a shot's
    state within a block's shared memory. Both limits are tested where the
    kernel is selected, on every device: a lifted code beyond either one
    decodes through the per-slot kernel, as a non-uniform one does, and on
    the CPU gives what a decoder built without the opt-in gives."""
    if limit == "degree":
        L, m_b, n_b, deg = 4, 2, 20, 17
    else:
        L, m_b, n_b, deg = 128, 27, 8, 8
    shifts = np.full((m_b, n_b), -1)
    for i in range(m_b):
        shifts[i, [(3 * i + t) % n_b for t in range(deg)]] = [
            (i + 2 * t) % L for t in range(deg)]
    st = QCStructure(L=L, shifts=shifts)
    cfg = DecoderConfig(dec_type="MS", max_iter=4, schedule="F")
    asked = ms_qc_cuda.make_qc_decoder(st, cfg, stacked=True)
    plain = ms_qc_cuda.make_qc_decoder(st, cfg, stacked=False)
    assert flood_qc_cuda.uniform_degree(st) == deg
    if limit == "degree":
        assert deg > flood_qc_cuda._KERNEL_MAX_DEG
        assert flood_qc_cuda.smem_bytes(asked.tabs) <= flood_qc_cuda._MAX_SMEM
    else:
        assert deg <= flood_qc_cuda._KERNEL_MAX_DEG
        assert flood_qc_cuda.smem_bytes(asked.tabs) > flood_qc_cuda._MAX_SMEM
        # kernel B keeps such a shot's state in device memory
        assert asked.state_on_device
    assert not flood_qc_cuda.supports(st, asked.tabs)
    assert asked.stacked is False and not hasattr(asked, "flood_gidx")
    syn = _syndromes(3, asked.H.numpy().astype(np.int64), 6, 0.01)
    syn[0] = 0
    p = np.float32(0.03) / np.float32(3.0)
    a, b = asked(torch.from_numpy(syn), p), plain(torch.from_numpy(syn), p)
    assert torch.equal(a.posterior, b.posterior)
    assert torch.equal(a.n_iter, b.n_iter) and bool(a.converged[0])
    assert syn[1:].any() and (a.posterior[1:] != a.posterior[0]).any()
    # within both limits the opt-in is taken
    assert ms_qc_cuda.make_qc_decoder(
        detect_qc(np.asarray(get_code("lp04_0").Hz) % 2), cfg,
        stacked=True).stacked
