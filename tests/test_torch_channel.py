"""The port's depolarizing channel is bit-exact with the reference's threefry
path (`sample_shot_tiles`): err_x, err_z and both syndromes, at several p
and code lengths (kernel A against its plain version on the card:
tests/test_torch_cuda.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpcsim_tpu.channel.depolarizing import (
    _u32_threshold,
    sample_shot_tiles as ref_sample_shot_tiles,
)
from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.parallel.mesh import chunk_keys as ref_chunk_keys

from qldpcsim_torch.channel.depolarizing import (
    sample_depolarizing,
    sample_shot_tiles,
)
from qldpcsim_torch.convert import keys_from_reference
from qldpcsim_torch.ops import channel_cuda


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PS = [1e-4, 0.01, 0.05, 0.1]


@pytest.mark.parametrize("p", PS + [0.0, 1.0, 0.3333333])
def test_thresholds_equal_reference(p):
    p32 = jnp.float32(p)
    ref = [int(_u32_threshold(q)) for q in (p32 / 3.0, 2.0 * p32 / 3.0, p32)]
    assert list(channel_cuda.thresholds(p)) == ref


@pytest.mark.parametrize("code,n_tiles", [("lp04_0", 3), ("lp118_0", 2)])
@pytest.mark.parametrize("p", PS)
def test_sample_shot_tiles_bit_exact(code, n_tiles, p):
    c = get_code(code)
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    n = Hx.shape[1]
    Hx_T, Hz_T = Hx.T.astype(np.float32), Hz.T.astype(np.float32)
    keys = ref_chunk_keys(jax.random.fold_in(jax.random.PRNGKey(11), 2), 4,
                          n_tiles)
    ref = [np.asarray(a) for a in ref_sample_shot_tiles(
        keys, jnp.float32(p), n, 64, Hx_T, Hz_T)]
    out = sample_shot_tiles(keys_from_reference(np.asarray(keys)), p, n, 64,
                            torch.from_numpy(Hx_T), torch.from_numpy(Hz_T))
    assert out[0].shape == (n_tiles * 64, n)
    for r, o in zip(ref, out):
        assert np.array_equal(r.astype(np.float32), o.numpy().astype(np.float32))
    if p >= 0.01:
        assert ref[0].any() and ref[1].any()


def test_sample_depolarizing_matches_reference():
    from qldpcsim_tpu.channel.depolarizing import (
        sample_depolarizing as ref_sample)

    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    rx, rz = ref_sample(key, jnp.float32(0.07), (5, 175))
    ox, oz = sample_depolarizing(keys_from_reference(np.asarray(key)), 0.07,
                                 (5, 175))
    assert np.array_equal(np.asarray(rx), ox.numpy())
    assert np.array_equal(np.asarray(rz), oz.numpy())


def test_cpu_tensors_take_the_plain_version():
    keys = keys_from_reference(np.asarray(
        ref_chunk_keys(jax.random.PRNGKey(0), 0, 2)))
    before = channel_cuda.LAUNCHES
    ex, ez = channel_cuda.sample_tiles(keys, 0.05, 175, 64)
    px, pz = channel_cuda.sample_tiles_plain(keys, 0.05, 175, 64)
    assert channel_cuda.LAUNCHES == before
    assert torch.equal(ex, px) and torch.equal(ez, pz)

