"""The port's reference-compatible shims (`qldpcsim_torch.compat`) against
the JAX package's (`qldpcsim_tpu.compat`), function by function on the same
inputs from a numpy seed, with `device="cpu"`: gf2math and PCMlibrary equal;
NG, BF and MS estimates and iteration counts equal shot for shot; BP held to
syndrome consistency where float32 tanh/log of the two libraries part;
OSDdec and simulate_p equal."""

import numpy as np
import pytest
import torch

from qldpcsim_tpu import compat as ref

from qldpcsim_torch import compat
from qldpcsim_torch.compat import (
    PCMlibrary,
    PMClibrary,
    decoders,
    gf2math,
    simulator,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shots(H, n_shots, p, seed=1717):
    rng = np.random.default_rng(seed)
    err = rng.random((n_shots, H.shape[1])) < p
    return (err.astype(np.int64) @ H.T.astype(np.int64)) % 2


def test_submodules_are_importable():
    import qldpcsim_torch.compat.decoders as d
    import qldpcsim_torch.compat.PMClibrary as lib

    assert d is decoders and lib is PCMlibrary and PMClibrary is PCMlibrary
    assert compat.__all__ == ref.__all__


@pytest.mark.parametrize("name,args", [
    ("shor_code", ()), ("steane_code", ()), ("bicycle_code", ()),
    ("qc_ldpc_tanner_code", ()), ("qc_ldpc_lifted_code", ("LP118", 0)),
    ("qc_ldpc_lifted_code", ("LP04", 2)),
])
def test_pcmlibrary_equals_reference(name, args):
    a = getattr(ref.PCMlibrary, name)(*args)
    b = getattr(PCMlibrary, name)(*args)
    assert len(a) == len(b) == 2
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("seed,shape", [(3, (12, 20)), (4, (20, 12)),
                                        (5, (16, 16))])
def test_gf2math_equals_reference(seed, shape):
    A = np.random.default_rng(seed).integers(0, 2, size=shape)
    assert gf2math.rank(A) == ref.gf2math.rank(A)
    for reduced in (False, True):
        for x, y in zip(ref.gf2math.REF(A, reduced=reduced),
                        gf2math.REF(A, reduced=reduced)):
            assert np.array_equal(x, y)
    assert np.array_equal(ref.gf2math.nullSpace(A), gf2math.nullSpace(A))
    assert np.array_equal(ref.gf2math.rowBasis(A), gf2math.rowBasis(A))
    if gf2math.rank(A) == A.shape[0]:
        for x, y in zip(ref.gf2math.systematic_form(A),
                        gf2math.systematic_form(A)):
            assert np.array_equal(np.asarray(x), np.asarray(y))
    else:
        with pytest.raises(ValueError):
            gf2math.systematic_form(A)


@pytest.mark.parametrize("code", ["steane", "lp04"])
def test_ng_bf_ms_decoders_equal_reference_shot_for_shot(code):
    Hz = (PCMlibrary.steane_code()[1] if code == "steane"
          else PCMlibrary.qc_ldpc_lifted_code("LP04", 0)[1])
    H = np.asarray(Hz) % 2
    layers = decoders.layerize(H)
    assert all(np.array_equal(a, b) for a, b in
               zip(layers, ref.decoders.layerize(H)))
    for syn in _shots(H, 6, 0.05):
        for name, args, kw in (
                ("NG_decoder", (), {}),
                ("BF_decoder", (), {}),
                ("BF_decoder", (), {"max_iter": 3}),
                ("MS_decoder", (0.02,), {"max_iter": 10}),
                ("MS_decoder", (0.02,), {"max_iter": 10, "layers": layers,
                                         "beta": 0.8})):
            e_r, it_r = getattr(ref.decoders, name)(H, syn, *args, **kw)
            e, it = getattr(decoders, name)(H, syn, *args, **kw,
                                            device="cpu")
            assert isinstance(e, np.ndarray) and isinstance(it, int)
            assert np.array_equal(np.asarray(e_r) % 2, e % 2), (name, kw)
            assert it == it_r, (name, kw)


def test_ms_decoder_with_osd_solves_the_syndrome_like_the_reference():
    """MS cut short, then OSD-2: the two packages' posteriors differ in
    their last bits on a lifted code (incremental against re-summed), which
    can reorder OSD's columns, so the estimates are held to what OSD
    promises: both satisfy the syndrome, after the same iterations."""
    H = np.asarray(PCMlibrary.qc_ldpc_lifted_code("LP04", 0)[1]) % 2
    n_osd = 0
    for syn in _shots(H, 6, 0.07):
        e_r, it_r = ref.decoders.MS_decoder(H, syn, 0.02, max_iter=3,
                                            OSDorder=2)
        e, it = decoders.MS_decoder(H, syn, 0.02, max_iter=3, OSDorder=2,
                                    device="cpu")
        assert it == it_r
        assert np.array_equal((H @ (e % 2)) % 2, syn)
        assert np.array_equal((H @ (np.asarray(e_r) % 2)) % 2, syn)
        n_osd += it == 3
    assert n_osd > 0


def test_bp_decoder_agrees_with_reference():
    H = np.asarray(PCMlibrary.qc_ldpc_lifted_code("LP04", 0)[1]) % 2
    same = 0
    syns = _shots(H, 8, 0.04)
    for syn in syns:
        e_r, it_r = ref.decoders.BP_decoder(H, syn, 0.02, max_iter=20)
        e, it = decoders.BP_decoder(H, syn, 0.02, max_iter=20, device="cpu")
        if np.array_equal(np.asarray(e_r) % 2, e % 2) and it == it_r:
            same += 1
        else:   # the two libraries' tanh/log part: same verdict at least
            ok = np.array_equal((H @ (e % 2)) % 2, syn)
            ok_r = np.array_equal((H @ (np.asarray(e_r) % 2)) % 2, syn)
            assert ok == ok_r
    assert same >= 6     # measured: 8 of 8


def test_osddec_equals_reference_and_leaves_its_inputs():
    H = np.asarray(PCMlibrary.qc_ldpc_lifted_code("LP04", 0)[1]) % 2
    rng = np.random.default_rng(5)
    for syn in _shots(H, 4, 0.08, seed=9):
        e0 = rng.integers(0, 2, H.shape[1])
        llr = rng.normal(2.0, 3.0, H.shape[1]).astype(np.float32)
        keep = (e0.copy(), syn.copy(), llr.copy())
        for order in (0, 2):
            a = ref.decoders.OSDdec(H, e0, syn, llr, order)
            b = decoders.OSDdec(H, e0, syn, llr, order, device="cpu")
            assert np.array_equal(np.asarray(a), b)
            assert np.array_equal((H @ b.astype(np.int64)) % 2, syn)
        assert all(np.array_equal(x, y) for x, y in zip(keep, (e0, syn, llr)))


@pytest.mark.parametrize("dec,kw", [
    ("MS", dict(decIterations=8)),
    ("MS", dict(decIterations=8, decSchedule="L", OSDorder=2)),
    ("BF", {}), ("NG", {}),
])
def test_simulate_p_dict_equals_reference(dec, kw):
    Hx, Hz = PCMlibrary.steane_code()
    a = ref.simulator.simulate_p(Hx, Hz, 0.05, shots=200, decType=dec,
                                 rngSeed=0, **kw)
    b = simulator.simulate_p(Hx, Hz, 0.05, shots=200, decType=dec, rngSeed=0,
                             device="cpu", **kw)
    assert a == b and len(b) == 6


def test_simulate_by_files_and_the_rest_of_the_surface(capsys):
    res = simulator.simulate("data/Hx_steane.npy", "data/Hz_steane.npy",
                             [0.02, 0.05], shots=128, decType="BF",
                             rngSeed=1, device="cpu")
    assert len(res) == 2 and "SIMULATION RESULTS" in capsys.readouterr().out
    assert simulator.load_matrix("data/Hx_steane.npy").shape == (3, 7)
    assert simulator.main(["--p", "0.1"]) == 2
    with pytest.raises(NotImplementedError, match="native GF\\(2\\) channel"):
        simulator.build_stim_circuit(None, None, 0.01)


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    Hx, Hz = PCMlibrary.steane_code()
    syn = np.zeros(3, np.int64)
    for call in (lambda: decoders.MS_decoder(Hz, syn, 0.01),
                 lambda: decoders.NG_decoder(Hz, syn),
                 lambda: decoders.OSDdec(Hz, np.zeros(7), syn, np.ones(7), 0),
                 lambda: simulator.simulate_p(Hx, Hz, 0.01, shots=64)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
