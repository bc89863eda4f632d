"""The port's CSS encoder against the JAX package's: the same generator and
logical bases, and from the same key the same codeword frames bit for bit
(the four bernoulli(0.5) draws of `jax.random.split(key, 4)`); frames are
annihilated by both check matrices."""

import jax
import numpy as np
import pytest
import torch

from qldpcsim_tpu.channel.encoder import CSSEncoder as RefEncoder
from qldpcsim_tpu.codes import get_code

from qldpcsim_torch.channel.encoder import CSSEncoder
from qldpcsim_torch.convert import keys_from_reference
from qldpcsim_torch.utils import threefry


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CODES = ["shor", "steane", "bicycle", "lp04_0", "lp118_0"]


@pytest.mark.parametrize("code", CODES)
def test_build_gives_the_reference_bases(code):
    c = get_code(code)
    ref, enc = RefEncoder.build(c.Hx, c.Hz), CSSEncoder.build(c.Hx, c.Hz)
    assert (enc.n, enc.k) == (ref.n, ref.k)
    for name in ("Gx", "Gz", "Lx", "Lz"):
        assert np.array_equal(np.asarray(getattr(ref, name)),
                              np.asarray(getattr(enc, name))), name


@pytest.mark.parametrize("code", CODES)
@pytest.mark.parametrize("seed,batch", [(0, 64), (7, 33)])
def test_frames_equal_the_reference_bit_for_bit(code, seed, batch):
    c = get_code(code)
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0x454E43)
    rx, rz = RefEncoder.build(Hx, Hz).encode(key, batch)
    fx, fz = CSSEncoder.build(Hx, Hz).encode(
        keys_from_reference(np.asarray(key)), batch)
    assert fx.dtype == fz.dtype == torch.int8 and fx.shape == (batch, Hx.shape[1])
    assert np.array_equal(np.asarray(rx), fx.numpy())
    assert np.array_equal(np.asarray(rz), fz.numpy())
    assert fx.any() and fz.any()
    # stabilizer and logical cosets: both check matrices annihilate a frame
    assert not ((fx.numpy().astype(np.int64) @ Hz.T) % 2).any()
    assert not ((fz.numpy().astype(np.int64) @ Hx.T) % 2).any()


def test_frame_key_is_the_fold_of_the_first_tile_key():
    """The engine's frame key: fold_in(tile_keys[0], 'ENC')."""
    k = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    ref = jax.random.fold_in(k, 0x454E43)
    out = threefry.fold_in(keys_from_reference(np.asarray(k)), 0x454E43)
    assert np.array_equal(np.asarray(ref).astype(np.int64), out.numpy())
