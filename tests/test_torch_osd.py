"""The port's OSD post-decoder (plain elimination on CPU tensors) is
bit-exact with the reference's `make_osd(platform="cpu")`, for orders 0, 1
and 2, on the posteriors of decoder-failed shots from the port's min-sum
decode (itself bit-exact with the reference's kernel). The reliability
order goes through float32 exp, which XLA and torch round differently in
the last ulp on some inputs; each case first asserts that both orders are
equal, so that such a difference would show up as what it is. Also the
order guard and the engine's windowed `_apply_osd`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.decoders.osd import make_osd as ref_make_osd

from qldpcsim_torch.decoders import DecoderConfig, build_layers
from qldpcsim_torch.decoders.osd import (
    OSD,
    pack_bits,
    popcount32,
    reliability_order,
)
from qldpcsim_torch.engine.montecarlo import ShotPipeline, SimConfig
from qldpcsim_torch.ops import ms_qc_cuda
from qldpcsim_torch.ops.qc import detect_qc


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


def _failed_shots(code, p, n_shots=96):
    """(H, e_hat, syndromes, posterior) of the shots an 8-iteration layered
    min-sum decode leaves unconverged."""
    H = np.asarray(get_code(code).Hz) % 2
    dec = ms_qc_cuda.make_qc_decoder(
        detect_qc(H), DecoderConfig(max_iter=8, schedule="L"),
        layers=build_layers(H, "L"))
    syn = _syndromes(7, H, n_shots, p)
    r = dec(torch.from_numpy(syn), np.float32(p) / np.float32(3.0))
    f = ~r.converged
    return (H, r.e_hat[f], torch.from_numpy(syn)[f].to(torch.float32),
            r.posterior[f])


@pytest.mark.parametrize("code,p", [("lp04_0", 0.08), ("lp118_0", 0.06)])
@pytest.mark.parametrize("order", [0, 1, 2])
def test_osd_equals_reference(code, p, order):
    H, e_hat, syn, post = _failed_shots(code, p)
    assert e_hat.shape[0] >= 16
    # both reliability orders first
    llr = jnp.clip(jnp.asarray(post.numpy()), -100.0, 100.0)
    prob = 1.0 / (1.0 + jnp.exp(llr))
    ref_perm = np.asarray(jnp.argsort(jnp.maximum(prob, 1.0 - prob), axis=-1))
    assert np.array_equal(reliability_order(post).numpy(), ref_perm)

    ref = jax.jit(ref_make_osd(H, order, platform="cpu"))
    out_ref = np.asarray(ref(e_hat.numpy(), syn.numpy(), post.numpy()))
    out = OSD(H, order)(e_hat, syn, post)
    assert out.dtype == torch.int8
    assert np.array_equal(out.numpy(), out_ref)
    # OSD's estimates reproduce the syndrome, which the decoder's did not
    est = (out.numpy().astype(np.int64) @ H.T.astype(np.int64)) % 2
    assert np.array_equal(est, syn.numpy().astype(np.int64))


def test_order_guard():
    H = np.asarray(get_code("steane").Hz) % 2
    with pytest.raises(ValueError, match="explode"):
        OSD(H, 7)
    with pytest.raises(ValueError, match=">= 0"):
        OSD(H, -1)
    assert OSD(H, 6).order == 6


def test_packing_helpers():
    bits = torch.zeros((2, 40), dtype=torch.int64)
    bits[0, [0, 31, 32, 39]] = 1
    bits[1, 5] = 1
    assert pack_bits(bits, 2).tolist() == [[1 + 2 ** 31, 1 + 2 ** 7],
                                           [2 ** 5, 0]]
    x = torch.tensor([0, 1, 2 ** 32 - 1, 0x0F0F0F0F, 2 ** 31 + 3])
    assert popcount32(x).tolist() == [0, 1, 32, 16, 3]


@pytest.mark.parametrize("B,kw", [
    (250, dict(dec_type="BP", dec_iterations=5, osd_order=1)),
    (600, dict(dec_type="MS", dec_iterations=3, osd_order=2)),
])
def test_apply_osd_windows(B, kw):
    """The engine's windowed OSD at a batch that shares no factors with 256
    (one window), and at one whose failures fill several 256-shot windows,
    is identical to OSD applied to the failed shots directly."""
    code = get_code("lp04_0")
    cfg = SimConfig(shots=B, batch_size=B, rng_seed=3, device="cpu", **kw)
    pipe = ShotPipeline(code.Hx, code.Hz, cfg)
    H = np.asarray(code.Hz) % 2
    syn = torch.from_numpy(_syndromes(11, H, B, 0.08)).to(torch.float32)
    res = pipe.dec_x(syn, 0.02)
    failed = ~res.converged
    assert failed.any(), "need failed shots to exercise the windows"
    if B > 256:
        assert int(failed.sum()) > 256
    out = pipe._apply_osd(pipe.osd_x, res.e_hat, res.posterior, syn, failed)
    direct = res.e_hat.clone()
    direct[failed] = pipe.osd_x(res.e_hat[failed], syn[failed],
                                res.posterior[failed])
    assert torch.equal(out, direct)
    assert torch.equal(out[~failed], res.e_hat[~failed])
    assert pipe.osd_shots == {"x": int(failed.sum()), "z": 0}
