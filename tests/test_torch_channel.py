"""The port's depolarizing channel is bit-exact with the reference's threefry
path (`sample_shot_tiles`): err_x, err_z and both syndromes, at several p,
code lengths and tile sizes, the syndromes formed as CSR parities (kernel A
against its plain version on the card: tests/test_torch_cuda.py); kernel
A's launch plan and C signature."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qldpcsim_tpu.channel.depolarizing import (
    _u32_threshold,
    sample_shot_tiles as ref_sample_shot_tiles,
    syndromes_of as ref_syndromes_of,
)
from qldpcsim_tpu.codes import get_code
from qldpcsim_tpu.parallel.mesh import chunk_keys as ref_chunk_keys

from qldpcsim_torch.channel.depolarizing import (
    sample_depolarizing,
    sample_shot_tiles,
    syndromes_of,
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
                            channel_cuda.SyndromeTables.build(Hx, Hz))
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
    H = np.asarray(get_code("lp04_0").Hz) % 2
    tabs = channel_cuda.SyndromeTables.build(H, H)
    out = sample_shot_tiles(keys, 0.05, 175, 64, tabs)
    plain = channel_cuda.sample_shot_tiles_plain(keys, 0.05, 175, 64, tabs)
    assert channel_cuda.LAUNCHES == before
    assert channel_cuda.SYN_LAUNCHES == 0
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert torch.equal(out[0], ex) and torch.equal(out[1], ez)


def _irregular_1000():
    """A seeded random 400 x 1000 matrix of row weights 0 to 24, with a
    zero-weight row (row 7)."""
    rng = np.random.default_rng(1000)
    H = np.zeros((400, 1000), np.int8)
    for i in range(400):
        H[i, rng.choice(1000, int(rng.integers(1, 25)), replace=False)] = 1
    H[7] = 0
    return H


def _matrices(name):
    """(Hx, Hz) of a library code, or the random irregular matrix as Hz
    beside its rows reversed as Hx."""
    if name == "irregular1000":
        H = _irregular_1000()
        return H[::-1].copy(), H
    c = get_code(name)
    return np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2


FUSED_CODES = ["lp04_0", "lp118_0", "tanner", "steane", "shor", "bicycle",
               "irregular1000"]
FUSED_PS = [0.0, 1e-4, 0.05, 0.3333333, 1.0]


@pytest.mark.parametrize("tile,n_tiles", [(64, 2), (4, 3), (1, 5)])
@pytest.mark.parametrize("code", FUSED_CODES)
def test_fused_plain_version_equals_reference(code, tile, n_tiles):
    """The fused launch's plain version (the errors and both syndromes as
    CSR parities) against the reference's `sample_shot_tiles`, bit for bit
    on all four outputs, at every p of `FUSED_PS`."""
    Hx, Hz = _matrices(code)
    n = Hx.shape[1]
    Hx_T, Hz_T = Hx.T.astype(np.float32), Hz.T.astype(np.float32)
    tabs = channel_cuda.SyndromeTables.build(Hx, Hz)
    keys = ref_chunk_keys(jax.random.fold_in(jax.random.PRNGKey(5), 1), 3,
                          n_tiles)
    tkeys = keys_from_reference(np.asarray(keys))
    for p in FUSED_PS:
        ref = [np.asarray(a).astype(np.float32) for a in ref_sample_shot_tiles(
            keys, jnp.float32(p), n, tile, Hx_T, Hz_T)]
        out = channel_cuda.sample_shot_tiles_plain(tkeys, p, n, tile, tabs)
        assert [tuple(o.shape) for o in out] == [
            (n_tiles * tile, n)] * 2 + [(n_tiles * tile, Hz.shape[0]),
                                       (n_tiles * tile, Hx.shape[0])]
        assert out[2].dtype == out[3].dtype == torch.float32
        for r, o in zip(ref, out):
            assert np.array_equal(r, o.numpy().astype(np.float32)), p
        if p == 1.0:
            # t(p) is the largest float32 below 2^32: almost every qubit
            assert out[0].float().mean() > 0.6


@pytest.mark.parametrize("code", ["lp118_0", "tanner", "bicycle",
                                  "irregular1000"])
def test_csr_parity_equals_syndromes_of(code):
    """`csr_parity` over random errors of every weight against the float32
    products of `syndromes_of`, the port's and the reference's."""
    Hx, Hz = _matrices(code)
    rng = np.random.default_rng(9)
    ex = (rng.random((70, Hx.shape[1])) < rng.random((70, 1))).astype(np.uint8)
    ez = (rng.random((70, Hx.shape[1])) < 0.5).astype(np.uint8)
    tabs = channel_cuda.SyndromeTables.build(Hx, Hz)
    assert tabs.z.m == Hz.shape[0] and tabs.x.m == Hx.shape[0]
    assert int(tabs.z.rp[-1]) == tabs.z.cols.numel() == int(Hz.sum())
    sz = channel_cuda.csr_parity(torch.from_numpy(ex), tabs.z)
    sx = channel_cuda.csr_parity(torch.from_numpy(ez), tabs.x)
    Hx_T, Hz_T = Hx.T.astype(np.float32), Hz.T.astype(np.float32)
    port = syndromes_of(torch.from_numpy(ex), torch.from_numpy(ez),
                        torch.from_numpy(Hx_T), torch.from_numpy(Hz_T))
    ref = ref_syndromes_of(jnp.asarray(ex), jnp.asarray(ez), Hx_T, Hz_T)
    for got, p_, r in zip((sz, sx), port, ref):
        assert torch.equal(got, p_)
        assert np.array_equal(got.numpy(), np.asarray(r))


@pytest.mark.parametrize("code", ["lp118_0", "tanner", "shor",
                                  "irregular1000"])
def test_check_table_holds_each_rows_columns(code):
    """The CSR table the kernel reads: row i's columns, ascending, are
    H's, and a zero-weight row has none."""
    for H in _matrices(code):
        tab = channel_cuda.CheckTable.build(H)
        assert tab.rp.dtype == tab.cols.dtype == torch.int32
        assert tab.m == H.shape[0] and int(tab.rp[0]) == 0
        for i in range(H.shape[0]):
            assert list(tab.cols[tab.rp[i]:tab.rp[i + 1]].numpy()) == list(
                np.flatnonzero(H[i]))


@pytest.mark.parametrize("n,tile,B,want", [
    (544, 64, 4096, (8, 256, 1088)),      # lp118_0: 512 blocks
    (1054, 64, 4096, (8, 256, 2112)),     # the Tanner code
    (12000, 64, 2048, (4, 256, 12000)),   # a large .npy code
    (12000, 64, 65536, (8, 256, 24000)),  # S shrinks for shared memory
    (544, 4, 300, (1, 256, 136)),         # tile 4
    (544, 1, 1, (1, 256, 136)),           # tile 1, a lone shot
    (7, 64, 4096, (8, 64, 16)),           # Steane: 8 shots in 2 words
    (7, 64, 65536, (32, 128, 56)),        # 32 shots, a word a column
    (9, 4, 300, (1, 32, 8)),              # Shor: one warp
    (544, 6, 3072, (2, 256, 272)),        # a tile of 6: S a power of two
])
def test_plan_is_pinned(n, tile, B, want):
    pl = channel_cuda.plan(n, tile, B)
    assert (pl.shots, pl.threads, pl.smem_bytes) == want
    assert tile % pl.shots == 0 and pl.smem_bytes <= channel_cuda.MAX_SMEM
    assert 1 << pl.log_shots == pl.shots


def test_plan_raises_beyond_shared_memory():
    channel_cuda.plan(929_792, 1, 64)     # 232,448 bytes: fits
    with pytest.raises(ValueError, match="1000000"):
        channel_cuda.plan(1_000_000, 1, 64)
    with pytest.raises(ValueError):
        channel_cuda.plan(544, 64, 100)   # B not a multiple of the tile


def test_ctypes_signature_matches_the_source():
    """The wrapper's argtypes for `channel_depolarizing` follow the C
    signature in csrc/channel.cu, type by type."""
    import ctypes
    import re
    from pathlib import Path

    src = (Path(channel_cuda.__file__).parent.parent / "csrc"
           / "channel.cu").read_text()
    sig = re.search(r"int channel_depolarizing\(([^)]*)\)", src).group(1)
    kinds = {"int": ctypes.c_int, "unsigned": ctypes.c_uint}
    want = [ctypes.c_void_p if "*" in p else kinds[p.split()[-2]]
            for p in (q.strip() for q in sig.split(","))]
    assert channel_cuda.ARGTYPES == want


def test_pipeline_chunk_syndromes_are_those_of_its_errors():
    """`ShotPipeline._sample_chunk` on the CPU: the channel's own syndromes
    equal `syndromes_of` of the errors it returns, with and without the
    encoder, and the errors are the same."""
    from qldpcsim_torch.engine.montecarlo import ShotPipeline, SimConfig
    from qldpcsim_torch.parallel.keys import chunk_keys
    from qldpcsim_torch.utils.threefry import prng_key

    c = get_code("lp04_0")
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    Hx_T = torch.as_tensor(Hx.T, dtype=torch.float32)
    Hz_T = torch.as_tensor(Hz.T, dtype=torch.float32)
    keys = chunk_keys(prng_key(4), 0, 2)
    outs = []
    for enc in (False, True):
        cfg = SimConfig(shots=128, dec_type="MS", dec_iterations=4,
                        batch_size=128, device="cpu", validate_encoding=enc)
        ex, ez, sz, sx = ShotPipeline(Hx, Hz, cfg)._sample_chunk(keys, 0.1)
        want = syndromes_of(ex, ez, Hx_T, Hz_T)
        assert torch.equal(sz, want[0]) and torch.equal(sx, want[1])
        outs.append((ex, ez, sz, sx))
    assert all(torch.equal(a, b) for a, b in zip(*outs))

