"""The block-row formulation of the serial QC decode (`seq_qc_plain_blockrow`,
the algorithm of kernel D in plain PyTorch: the L rows of a block-row in one
vectorised step, committed per shot up to the row where it latches) against
the row-by-row plain version `seq_qc_plain`, which is held against the
reference's Pallas kernel in tests/test_torch_seq_qc.py (where the block-row
formulation is also held against that kernel directly, MS).

Tolerance 0, MS and BP: n_iter and converged equal, the posterior equal by
value on every element (both run the same float32 operations on the same
inputs; `==` takes -0.0 and 0.0 as equal)."""

import numpy as np
import pytest
import torch

from qldpcsim_torch.codes import get_code
from qldpcsim_torch.decoders import DecoderConfig, build_layers
from qldpcsim_torch.ops import seq_qc_cuda
from qldpcsim_torch.ops.ms_qc_cuda import llr_prior
from qldpcsim_torch.ops.qc import QCStructure, detect_qc

LCH = llr_prior(np.float32(0.05) / np.float32(3.0))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _decoder(code, kind, max_iter):
    H = np.asarray(get_code(code).Hz) % 2
    dec = seq_qc_cuda.make_seq_qc_decoder(
        detect_qc(H), DecoderConfig(dec_type=kind, max_iter=max_iter,
                                    schedule="S"),
        layers=build_layers(H, "S"), kind=kind)
    return H, dec


def _syndromes(seed, H, n_shots, p):
    rng = np.random.default_rng(seed)
    errs = (rng.random((n_shots, H.shape[1])) < p).astype(np.int64)
    syn = ((errs @ H.T.astype(np.int64)) % 2).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(syn.T))


def _both(dec, syn_T, lch=LCH):
    rows = torch.full((syn_T.shape[1],), -1, dtype=torch.int64)
    ref = seq_qc_cuda.seq_qc_plain(dec, syn_T, lch)
    got = seq_qc_cuda.seq_qc_plain_blockrow(dec, syn_T, lch, latch_row=rows)
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert got[0].shape == ref[0].shape and bool((got[0] == ref[0]).all())
    assert torch.equal(got[0] < 0, ref[0] < 0)
    assert got[1].dtype == torch.int32 and got[2].dtype == torch.bool
    # a shot has a latch row exactly when it converged
    assert torch.equal(rows >= 0, ref[2])
    return ref, rows


@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("code,max_iter,n_shots,p_err", [
    ("lp04_0", 30, 32, 0.03),
    ("tanner", 3, 8, 0.02),        # lift 31: a block-row is 31 rows
    ("lp118_0", 4, 8, 0.03),       # lift 16
])
def test_blockrow_equals_row_by_row(kind, code, max_iter, n_shots, p_err):
    H, dec = _decoder(code, kind, max_iter)
    (post, n_iter, conv), _ = _both(dec, _syndromes(5, H, n_shots, p_err))
    assert conv.any() and len(torch.unique(n_iter)) >= 2


@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("lch", [LCH, -0.5])
def test_blockrow_zero_syndromes(kind, lch):
    """W == 0 before any update, and the test follows row 0's update: every
    shot latches after row 0 of iteration 0. A negative prior starts from
    the all-ones estimate instead, whose syndrome is the row parity."""
    H, dec = _decoder("lp04_0", kind, 6)
    syn_T = torch.zeros((H.shape[0], 4))
    (post, n_iter, conv), rows = _both(dec, syn_T, lch)
    if lch > 0:
        assert conv.all() and (n_iter == 1).all() and (rows == 0).all()
        assert not (post < 0).any()


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_blockrow_latches_at_first_middle_and_last_row(kind):
    """Shots that latch after the first, a middle and the last row of a
    block-row, after a sign flip and not only on a zero syndrome: rows
    above the latch row are dropped, rows up to it are kept."""
    H, dec = _decoder("lp04_0", kind, 30)
    L = dec.tabs.L
    syn_T = _syndromes(11, H, 96, 0.02)
    (post, n_iter, conv), rows = _both(dec, syn_T)
    busy = conv & (syn_T.sum(dim=0) > 0)
    r = rows[busy] % L
    assert (r == 0).any() and (r == L - 1).any()
    assert ((r > 0) & (r < L - 1)).any()
    # latches in the middle of an iteration too, not only in its first rows
    assert (rows[busy] >= L).any() and (n_iter[busy] >= 2).any()


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_blockrow_shots_at_the_cap(kind):
    H, dec = _decoder("lp04_0", kind, 5)
    (post, n_iter, conv), rows = _both(dec, _syndromes(3, H, 32, 0.12))
    assert (~conv).sum() >= 8 and (n_iter[~conv] == 5).all()
    assert (rows[~conv] == -1).all()


@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_blockrow_irregular_lift(kind):
    """A synthetic lifted code whose block-rows have degrees 2 to 4 and
    whose variable blocks are met by 1 to 3 block-rows."""
    shifts = np.full((4, 5), -1)
    shifts[0, [0, 1]] = [1, 3]
    shifts[1, [1, 2, 3]] = [0, 2, 4]
    shifts[2, [0, 2, 3, 4]] = [2, 1, 0, 3]
    shifts[3, [1, 4]] = [4, 1]
    st = QCStructure(L=5, shifts=shifts)
    dec = seq_qc_cuda.make_seq_qc_decoder(
        st, DecoderConfig(dec_type=kind, max_iter=12, schedule="S"),
        kind=kind)
    H = st.lift()
    assert np.array_equal(dec.lifted_T().numpy().T, H)
    assert sorted(set(H.sum(axis=1))) == [2, 3, 4]
    (post, n_iter, conv), _ = _both(dec, _syndromes(2, H, 48, 0.08))
    assert conv.any() and (~conv).any()
