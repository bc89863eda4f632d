"""The port's own code library, GF(2) algebra and QC detection
(`qldpcsim_torch.codes`, `.gf2`, `.ops.qc`) against the JAX package's and the
`data/*.npy` matrices: bit for bit (integers; tolerance 0) on every registry
code."""

from pathlib import Path

import numpy as np
import pytest

import qldpcsim_torch.codes as tcodes
import qldpcsim_torch.gf2 as tgf2
import qldpcsim_torch.ops.qc as tqc
import qldpcsim_tpu.codes as rcodes
import qldpcsim_tpu.gf2 as rgf2
import qldpcsim_tpu.ops.qc as rqc

DATA = Path(__file__).resolve().parents[1] / "data"

# registry name -> suffix of data/Hx_<suffix>.npy
NAMES = {
    "shor": "shor", "steane": "steane", "bicycle": "bicycle", "tanner": "T",
    "lp04_0": "LP04_0", "lp04_1": "LP04_1", "lp04_2": "LP04_2",
    "lp04_3": "LP04_3", "lp118_0": "LP118_0", "lp118_1": "LP118_1",
    "lp118_2": "LP118_2",
}


def test_registry_names():
    assert sorted(tcodes.CODE_REGISTRY) == sorted(rcodes.CODE_REGISTRY)
    assert sorted(tcodes.CODE_REGISTRY) == sorted(NAMES)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_matrices_equal_reference_and_data(name):
    code = tcodes.get_code(name)
    ref = rcodes.get_code(name)
    for side in ("Hx", "Hz"):
        H = getattr(code, side)
        assert H.dtype == np.int8
        assert np.array_equal(H, getattr(ref, side))
        path = str(DATA / f"{side}_{NAMES[name]}.npy")
        assert np.array_equal(H, tcodes.load_matrix(path))
        assert np.array_equal(H, rcodes.load_matrix(path))
    assert code.n == ref.n
    loaded = tcodes.code_from_files(str(DATA / f"Hx_{NAMES[name]}.npy"),
                                    str(DATA / f"Hz_{NAMES[name]}.npy"))
    assert np.array_equal(loaded.Hx, code.Hx)
    assert np.array_equal(loaded.Hz, code.Hz)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_gf2_equals_reference(name):
    code = tcodes.get_code(name)
    for H in (code.Hx, code.Hz):
        assert tgf2.rank(H) == rgf2.rank(H)
        assert np.array_equal(tgf2.null_space(H), rgf2.null_space(H))
        assert np.array_equal(tgf2.row_basis(H), rgf2.row_basis(H))
    assert tgf2.css_k(code.Hx, code.Hz) == rgf2.css_k(code.Hx, code.Hz)
    assert tgf2.check_css(code.Hx, code.Hz)
    Lx, Lz = tgf2.logical_ops(code.Hx, code.Hz)
    Rx, Rz = rgf2.logical_ops(code.Hx, code.Hz)
    assert np.array_equal(Lx, Rx) and np.array_equal(Lz, Rz)
    assert code.k == Lx.shape[0]


@pytest.mark.parametrize("name", sorted(NAMES))
def test_detect_qc_equals_reference(name):
    code = tcodes.get_code(name)
    for H in (code.Hx, code.Hz):
        st, ref = tqc.detect_qc(H), rqc.detect_qc(H)
        assert (st is None) == (ref is None)
        if st is None:
            continue
        assert (st.L, st.m_b, st.n_b) == (ref.L, ref.m_b, ref.n_b)
        assert np.array_equal(st.shifts, ref.shifts)
        for i in range(st.m_b):
            assert st.blocks_of_row(i) == ref.blocks_of_row(i)


def test_ref_and_systematic_form_equal_reference():
    H = tcodes.get_code("lp04_0").Hx
    for a, b in zip(tgf2.rref(H), rgf2.rref(H)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    full = tgf2.row_basis(H)
    for a, b in zip(tgf2.systematic_form(full), rgf2.systematic_form(full)):
        assert np.array_equal(a, b)


def test_load_matrix_text(tmp_path):
    path = tmp_path / "h.txt"
    path.write_text("1 0 3\n\n0 1 1\n")
    assert np.array_equal(tcodes.load_matrix(str(path)),
                          np.array([[1, 0, 1], [0, 1, 1]], np.int8))
