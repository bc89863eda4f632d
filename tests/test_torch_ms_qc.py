"""The port's min-sum QC decoder (plain version on CPU tensors) is bit-exact
with the reference's Pallas kernel run in interpret mode: e_hat, n_iter,
converged and the posterior, under F and L, at a batch that is not a
multiple of the kernel's block (kernel B against its plain version on the
card: tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders import DecoderConfig as RefConfig
from qldpcsim_tpu.decoders import build_layers as ref_build_layers
from qldpcsim_tpu.ops.ms_qc_pallas import make_ms_qc_decoder
from qldpcsim_tpu.ops.qc import block_groups_of_layers, detect_qc

from qldpcsim_torch.convert import qc_tables_from_reference
from qldpcsim_torch.decoders import DecoderConfig, build_layers
from qldpcsim_torch.ops import ms_qc_cuda


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


def _both(code, sched, max_iter):
    H = np.asarray(get_code(code).Hz) % 2
    st = detect_qc(H)
    ref = make_ms_qc_decoder(
        st, RefConfig(dec_type="MS", max_iter=max_iter, schedule=sched),
        layers=ref_build_layers(H, sched), B_blk=32, interpret=True)
    port = ms_qc_cuda.make_qc_decoder(
        st, DecoderConfig(dec_type="MS", max_iter=max_iter, schedule=sched),
        layers=build_layers(H, sched))
    return H, ref, port


def _assert_same(r, o):
    assert np.array_equal(np.asarray(r.e_hat), o.e_hat.numpy())
    assert np.array_equal(np.asarray(r.n_iter), o.n_iter.numpy())
    assert np.array_equal(np.asarray(r.converged), o.converged.numpy())
    # bit-exact posterior: same float32 operations in the same order
    assert np.array_equal(np.asarray(r.posterior), o.posterior.numpy())


@pytest.mark.parametrize("code,sched", [
    ("lp04_0", "F"), ("lp04_0", "L"), ("lp118_0", "L"), ("tanner", "L"),
])
@pytest.mark.parametrize("max_iter", [8, 50])
def test_plain_equals_pallas_interpret(code, sched, max_iter):
    H, ref, port = _both(code, sched, max_iter)
    syn = _syndromes(5, H, 40, 0.06)
    p = np.float32(0.05) / np.float32(3.0)
    r, o = ref(syn, p), port(torch.from_numpy(syn), p)
    _assert_same(r, o)
    conv = np.asarray(r.converged)
    assert conv.any() and (max_iter == 50 or not conv.all())


def test_zero_syndrome_converges_at_once():
    H, ref, port = _both("lp118_0", "L", 5)
    syn = np.zeros((8, H.shape[0]), np.int8)
    r, o = ref(syn, 0.01), port(torch.from_numpy(syn), 0.01)
    _assert_same(r, o)
    assert o.converged.all() and (o.n_iter == 1).all()
    assert not o.e_hat.any()


@pytest.mark.parametrize("p", [1e-4, 0.01, 0.02, 0.05, 0.1, 1e-5, 0.001,
                               0.03, 0.06, 0.07, 0.08, 0.12, 0.3])
def test_llr_prior_equals_reference(p):
    """The engine's prior p/3 and the decoder tests' p points give the same
    float32 LLR as the reference's XLA log."""
    for q in (np.float32(p) / np.float32(3.0), np.float32(p)):
        q32 = jnp.float32(q)
        ref = jnp.log((1.0 - q32) / jnp.maximum(q32, 1e-9))
        assert np.float32(ms_qc_cuda.llr_prior(q)) == np.asarray(ref)


def test_tables_follow_reference_structures():
    H = np.asarray(get_code("lp118_0").Hz) % 2
    st = detect_qc(H)
    groups = block_groups_of_layers(build_layers(H, "L"), st)
    assert groups == [[0], [1], [2, 3], [4], [5, 6], [7], [8, 9], [10],
                      [11, 12], [13], [14]]
    t = qc_tables_from_reference(st, groups)
    assert (t.L, t.n_b, t.m_b, t.n_slots, t.max_deg) == (16, 34, 15, 120, 8)
    # layered groups share no variable block (no snapshot needed); the
    # flooding group does
    assert not t.group_snap.any()
    assert qc_tables_from_reference(st, [list(range(st.m_b))]).group_snap[0]
    lifted = np.zeros_like(H)
    for i in range(t.m_b):
        gi = t.gather_index(i)
        for r in range(t.L):
            lifted[i * t.L + r, gi[:, r]] = 1
    assert np.array_equal(lifted, H)
    with pytest.raises(ValueError):
        qc_tables_from_reference(st, [[1, 0]] + [[i] for i in range(2, 15)])


def test_unsupported_options_raise():
    st = detect_qc(np.asarray(get_code("lp04_0").Hz) % 2)
    with pytest.raises(NotImplementedError):
        ms_qc_cuda.make_qc_decoder(st, DecoderConfig(qc_check_every="layer"))
    with pytest.raises(ValueError):
        ms_qc_cuda.make_qc_decoder(st, DecoderConfig(dec_type="BF"))
    with pytest.raises(ValueError):
        ms_qc_cuda.make_qc_decoder(st, DecoderConfig(schedule="S"))

