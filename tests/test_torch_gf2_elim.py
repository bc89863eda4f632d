"""The port's GF(2) elimination (plain version on CPU tensors) is bit-exact
with both of the reference's Pallas elimination kernels in interpret mode
(`make_eliminate_panel`, the default, and `make_eliminate_pallas`): tags,
pivots and the selected columns, on random column orders of the library
codes. It selects the greedy rank-increase basis, and its tags solve
H_sel x = s (kernel C against this plain version on the card:
tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpcsim_tpu import gf2
from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders.osd import OSDStatic as RefOSDStatic
from qldpcsim_tpu.ops.gf2_elim_pallas import make_eliminate_pallas
from qldpcsim_tpu.ops.gf2_elim_panel_pallas import make_eliminate_panel

from qldpcsim_torch.convert import osd_static_from_reference
from qldpcsim_torch.decoders.osd import OSDStatic
from qldpcsim_torch.ops import gf2_elim_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(code, B, seed):
    H = np.asarray(get_code(code).Hz) % 2
    st = RefOSDStatic.build(H)
    rng = np.random.default_rng(seed)
    perms = np.stack([rng.permutation(st.n) for _ in range(B)])
    tab = osd_static_from_reference(st)
    out = gf2_elim_cuda.eliminate(tab.cols[torch.from_numpy(perms)], st.r,
                                  st.rW)
    return H, st, perms, [a.numpy() for a in out]


def _same(ref, port):
    tags, pivots, sel = (np.asarray(a) for a in ref)
    assert np.array_equal(port[0].view(np.uint32), tags)
    assert np.array_equal(port[1], pivots)
    assert np.array_equal(port[2], sel)


@pytest.mark.parametrize("code", ["lp04_0", "lp118_0"])
def test_plain_equals_panel_kernel(code):
    H, st, perms, port = _setup(code, 8, 31)
    elim = make_eliminate_panel(st.n, st.r, st.mW, st.rW, B_blk=8, panel=8,
                                interpret=True)
    _same(elim(jnp.asarray(st.cols_packed[perms])), port)


@pytest.mark.parametrize("code", ["lp04_0", "lp118_0"])
def test_plain_equals_r4_kernel(code):
    H, st, perms, port = _setup(code, 8, 32)
    elim = make_eliminate_pallas(st.n, st.r, st.mW, st.rW, B_blk=8,
                                 interpret=True)
    _same(elim(jnp.asarray(st.cols_packed[perms])), port)
    assert (port[1] >= 0).all() and (port[2].sum(axis=1) == st.r).all()


@pytest.mark.parametrize("code,B", [("lp04_0", 6), ("lp118_0", 4)])
def test_selects_the_greedy_basis_and_tags_solve(code, B):
    """The numpy oracle of test_qc_kernel.py: a column joins the basis iff it
    raises the rank of the columns chosen before it; and XOR-ing the tags
    of the rows whose pivot s covers gives x with H_sel x = s."""
    H, st, perms, (tags, pivots, sel) = _setup(code, B, 33)
    tags = tags.view(np.uint32)
    rng = np.random.default_rng(34)
    for b in range(B):
        Hp = H[:, perms[b]]
        cis, rank = [], 0
        for j in range(st.n):
            if gf2.rank(Hp[:, cis + [j]]) > rank:
                cis.append(j)
                rank += 1
                if rank == st.r:
                    break
        assert np.array_equal(np.nonzero(sel[b])[0], cis), b
        x_true = rng.integers(0, 2, size=st.r)
        s = (Hp[:, cis] @ x_true) % 2
        x = np.zeros(st.rW, np.uint32)
        for k in range(st.r):
            pv = pivots[b, k]
            if pv >= 0 and s[pv]:
                x ^= tags[b, k]
        x_bits = (x[np.arange(st.r) >> 5] >> (np.arange(st.r) & 31)) & 1
        assert np.array_equal(x_bits, x_true), b


def test_static_tables_equal_reference():
    for code, shape in (("lp04_0", (84, 175, 78, 3, 3)),
                        ("lp118_0", (240, 544, 232, 8, 8))):
        H = np.asarray(get_code(code).Hz) % 2
        ref, port = RefOSDStatic.build(H), OSDStatic.build(H)
        assert (port.m, port.n, port.r, port.mW, port.rW) == shape
        assert (ref.m, ref.n, ref.r, ref.mW, ref.rW) == shape
        assert np.array_equal(ref.cols_packed, port.cols_packed)
        tab = osd_static_from_reference(port)
        assert tab.cols.dtype == torch.int32
        assert np.array_equal(tab.cols.numpy().view(np.uint32),
                              ref.cols_packed)


def test_empty_batch_and_word_helpers():
    st = OSDStatic.build(np.asarray(get_code("lp04_0").Hz) % 2)
    tab = osd_static_from_reference(st)
    tags, pivots, sel = gf2_elim_cuda.eliminate(
        tab.cols[torch.zeros((0, st.n), dtype=torch.int64)], st.r, st.rW)
    assert tags.shape == (0, st.r, st.rW) and sel.shape == (0, st.n)
    w = torch.tensor([0, 1, 2 ** 31 - 1, -2 ** 31, -1], dtype=torch.int32)
    wide = gf2_elim_cuda.words_to_int64(w)
    assert wide.tolist() == [0, 1, 2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1]
    assert torch.equal(gf2_elim_cuda.words_to_int32(wide), w)
    x = torch.tensor([[1, 2, 4, 7, 8]], dtype=torch.int64)
    assert gf2_elim_cuda.xor_fold(x, 1).tolist() == [1 ^ 2 ^ 4 ^ 7 ^ 8]
