"""The CUDA kernels against their plain PyTorch versions on the card, and
the wrappers' checks. Imports no jax, so that it runs on a machine without
it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py imports jax). Tests marked `cuda` skip
when torch sees no CUDA device."""

import dataclasses

import numpy as np
import pytest
import torch

from qldpcsim_torch.codes import get_code
from qldpcsim_torch.convert import osd_static_from_reference
from qldpcsim_torch.decoders import DecoderConfig, build_layers
from qldpcsim_torch.decoders.common import LayerSchedule
from qldpcsim_torch.decoders.osd import OSD, OSDStatic
from qldpcsim_torch.channel.depolarizing import syndromes_of
from qldpcsim_torch.engine import montecarlo
from qldpcsim_torch.engine.montecarlo import ShotPipeline, SimConfig, simulate_p
from qldpcsim_torch.ops import (
    _build,
    channel_cuda,
    flood_qc_cuda,
    general_h_cuda,
    gf2_elim_cuda,
    ms_qc_cuda,
    seq_qc_cuda,
)
from qldpcsim_torch.ops.qc import QCStructure, detect_qc
from qldpcsim_torch.parallel.keys import chunk_keys
from qldpcsim_torch.utils.threefry import fold_in, prng_key


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _syndromes(seed, H, n_shots, p, device):
    rng = np.random.default_rng(seed)
    errs = (rng.random((n_shots, H.shape[1])) < p).astype(np.int64)
    syn = ((errs @ H.T.astype(np.int64)) % 2).astype(np.float32)
    return torch.from_numpy(syn).to(device)


def _decoder(H, sched, device, max_iter=50, kind="MS", chk="iter",
             stacked=False):
    return ms_qc_cuda.make_qc_decoder(
        detect_qc(H), DecoderConfig(dec_type=kind, max_iter=max_iter,
                                    schedule=sched, qc_check_every=chk),
        layers=build_layers(H, sched), device=device, stacked=stacked)


def _seq_decoder(H, device, max_iter, kind="MS"):
    return seq_qc_cuda.make_seq_qc_decoder(
        detect_qc(H), DecoderConfig(dec_type=kind, max_iter=max_iter,
                                    schedule="S"),
        layers=build_layers(H, "S"), device=device, kind=kind)


def _synthetic_lift(name):
    """Lifted codes the library has none of: block-rows of degrees 2 to 5
    (`irregular`), a uniform degree of 12 (`deg12`), and a state beyond a
    block's shared memory for every QC kernel (`oversize`: 60 block-rows of
    degree 14 over 120 variable blocks of lift 64)."""
    rng = np.random.default_rng(21)
    if name == "irregular":
        L, m_b, n_b = 9, 6, 10
        degs = [2, 5, 3, 4, 5, 2]
    elif name == "deg12":
        L, m_b, n_b = 8, 3, 14
        degs = [12] * m_b
    else:
        L, m_b, n_b = 64, 60, 120
        degs = [14] * m_b
    shifts = np.full((m_b, n_b), -1)
    for i, d in enumerate(degs):
        shifts[i, rng.choice(n_b, d, replace=False)] = rng.integers(0, L, d)
    return QCStructure(L=L, shifts=shifts)


def _grouped_layers(st, sizes):
    """Layers of whole block-rows, `sizes` block-rows each: groups whose
    block-rows share a variable block read a snapshot."""
    layers, i = [], 0
    for size in sizes:
        layers.append(np.arange(i * st.L, (i + size) * st.L))
        i += size
    assert i == st.m_b
    return LayerSchedule.from_layers(layers, st.m)


def _assert_b_equals_plain(dec, syn_T, lch):
    """Kernel B against its plain version, bit for bit; returns the
    kernel's (posterior, n_iter, converged)."""
    before = dict(ms_qc_cuda.LAUNCHES)
    kp, ki, kc = ms_qc_cuda.ms_qc_cuda(dec, syn_T, lch)
    pp, pi, pc = ms_qc_cuda.ms_qc_plain(dec, syn_T, lch)
    torch.cuda.synchronize()
    assert ms_qc_cuda.LAUNCHES == dict(
        before, **{dec.kind: before[dec.kind] + 1})
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    assert torch.equal(kp, pp)
    return kp, ki, kc


def _general_matrix(name):
    """Matrices with no circulant lift: lp118_0's Hz with its columns
    permuted (240 x 544, row weight 8), bicycle's Hz (73 x 146, row weight
    18, one-row layers), Steane's Hz (3 x 7), a random 240 x 544 matrix of
    row weights 3 to 8, one of 12 x 200 with rows of 33 to 40 slots
    (`wide`: a thread per check row only), and one of 3000 x 6000 with rows
    of 18 to 20 slots whose per-shot state exceeds a block's shared memory
    (`oversize`)."""
    if name == "lp118_perm":
        perm = np.random.default_rng(118).permutation(544)
        H = (np.asarray(get_code("lp118_0").Hz) % 2)[:, perm]
    elif name in ("bicycle", "steane"):
        H = np.asarray(get_code(name).Hz) % 2
    else:
        m, n, lo, hi, seed = {"irregular": (240, 544, 3, 8, 7),
                              "wide": (12, 200, 33, 40, 3),
                              "oversize": (3000, 6000, 18, 20, 5)}[name]
        rng = np.random.default_rng(seed)
        H = np.zeros((m, n), np.int8)
        for i in range(m):
            H[i, rng.choice(n, int(rng.integers(lo, hi + 1)),
                            replace=False)] = 1
    assert detect_qc(H) is None
    return H.astype(np.int8)


def _gh_decoder(H, sched, device, max_iter, kind="MS"):
    return general_h_cuda.make_gh_decoder(
        H, DecoderConfig(dec_type=kind, max_iter=max_iter, schedule=sched),
        layers=build_layers(H, sched), device=device, kind=kind)


def _permuted_columns(code, B, seed, device):
    st = OSDStatic.build(np.asarray(get_code(code).Hz) % 2)
    rng = np.random.default_rng(seed)
    perms = torch.from_numpy(np.stack([rng.permutation(st.n)
                                       for _ in range(B)]))
    cols = osd_static_from_reference(st, device=device).cols
    return st, cols[perms.to(device)]


def _oversize_check_matrix():
    """A 1200 x 2400 parity-check matrix of column weight 3 (seed 12):
    kernel C's basis, about 1,190 rows of 77 words, exceeds a block's
    shared memory and lies in device memory."""
    rng = np.random.default_rng(12)
    H = np.zeros((1200, 2400), np.int8)
    for j in range(2400):
        H[rng.choice(1200, 3, replace=False), j] = 1
    return H


def _elim_window(H, B, seed, device, doubled=False):
    """B random column orders of H (of [H | H] with `doubled`: every column
    has a dependent twin) as kernel C's packed input."""
    if doubled:
        H = np.concatenate([H, H], axis=1)
    st = OSDStatic.build(H)
    rng = np.random.default_rng(seed)
    perms = torch.from_numpy(np.stack([rng.permutation(st.n)
                                       for _ in range(B)]))
    cols = osd_static_from_reference(st, device=device).cols
    return st, cols[perms.to(device)].contiguous()


def _assert_c_equals_plain(st, colsP, pairs):
    """Kernel C under one mapping against its plain version, bit for bit."""
    pl = gf2_elim_cuda.plan(st.r, st.mW, st.rW, pairs=pairs)
    before = gf2_elim_cuda.LAUNCHES
    kt, kp, ks = gf2_elim_cuda.eliminate_cuda(colsP, st.r, st.rW, pl)
    pt, pp, ps = gf2_elim_cuda.eliminate_plain(colsP, st.r, st.rW)
    torch.cuda.synchronize()
    assert gf2_elim_cuda.LAUNCHES == before + 1
    assert torch.equal(kt, pt) and torch.equal(kp, pp) and torch.equal(ks, ps)
    assert (kp >= 0).all() and (ks.sum(dim=1) == st.r).all()
    return pl


def test_wrappers_reject_malformed_input():
    with pytest.raises(ValueError):
        channel_cuda.sample_tiles_cuda(torch.zeros(4, 3, dtype=torch.int64),
                                       0.05, 544, 64)
    with pytest.raises(ValueError):
        channel_cuda.sample_tiles_cuda(torch.zeros(4, 2, dtype=torch.int32),
                                       0.05, 544, 64)
    L4 = np.asarray(get_code("lp04_0").Hz) % 2
    tabs = channel_cuda.SyndromeTables.build(L4, L4)
    with pytest.raises(ValueError):
        channel_cuda.sample_shot_tiles_cuda(
            torch.zeros(4, 3, dtype=torch.int64), 0.05, 175, 64, tabs)
    with pytest.raises(ValueError):
        channel_cuda.sample_shot_tiles_cuda(
            torch.zeros(4, 2, dtype=torch.int32), 0.05, 175, 64, tabs)
    with pytest.raises(ValueError):     # tables of another code
        channel_cuda.sample_shot_tiles_cuda(
            torch.zeros(4, 2, dtype=torch.int64), 0.05, 544, 64, tabs)
    H = np.asarray(get_code("lp04_0").Hz) % 2
    dec = _decoder(H, "L", "cpu", max_iter=4)
    with pytest.raises(ValueError):
        ms_qc_cuda.ms_qc_cuda(dec, torch.zeros(H.shape[0] + 1, 8), 1.0)
    with pytest.raises(ValueError):
        ms_qc_cuda.ms_qc_cuda(dec, torch.zeros(H.shape[0], 8,
                                               dtype=torch.float64), 1.0)
    seq = _seq_decoder(H, "cpu", 4)
    with pytest.raises(ValueError):
        seq_qc_cuda.seq_qc_cuda(seq, torch.zeros(H.shape[0] + 1, 8), 1.0)
    with pytest.raises(ValueError):
        seq_qc_cuda.seq_qc_cuda(seq, torch.zeros(8, H.shape[0]).T, 1.0)
    gh = _gh_decoder(_general_matrix("bicycle"), "L", "cpu", 4)
    with pytest.raises(ValueError):
        general_h_cuda.general_h_cuda(gh, torch.zeros(74, 8), 1.0)
    with pytest.raises(ValueError):
        general_h_cuda.general_h_cuda(gh, torch.zeros(73, 8,
                                                      dtype=torch.float64),
                                      1.0)


@pytest.mark.parametrize("shape,dtype,r,rW", [
    ((4, 175, 3), torch.int64, 78, 3),      # wrong word type
    ((4, 175), torch.int32, 78, 3),         # not (B, n, mW)
    ((4, 175, 3), torch.int32, 78, 2),      # tag words do not cover r
    ((4, 175, 3), torch.int32, 97, 4),      # rank beyond the check words
])
def test_gf2_elim_wrapper_rejects_malformed_input(shape, dtype, r, rW):
    with pytest.raises(ValueError):
        gf2_elim_cuda.eliminate_cuda(torch.zeros(shape, dtype=dtype), r, rW)


def test_other_devices_raise():
    keys = torch.zeros(2, 2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        channel_cuda.sample_tiles(keys, 0.05, 175, 64)
    L4 = np.asarray(get_code("lp04_0").Hz) % 2
    with pytest.raises(ValueError):
        montecarlo.sample_shot_tiles(
            keys, 0.05, 175, 64, channel_cuda.SyndromeTables.build(L4, L4))
    H = np.asarray(get_code("lp04_0").Hz) % 2
    with pytest.raises(ValueError):
        ms_qc_cuda.ms_qc(_decoder(H, "L", "cpu", max_iter=4),
                         torch.zeros(H.shape[0], 8, device="meta"), 1.0)
    with pytest.raises(ValueError):
        flood_qc_cuda.flood_qc(_decoder(H, "F", "cpu", 4, stacked=True),
                               torch.zeros(8, H.shape[0], device="meta"), 1.0)
    with pytest.raises(ValueError):
        gf2_elim_cuda.eliminate(torch.zeros((2, 175, 3), dtype=torch.int32,
                                            device="meta"), 78, 3)
    with pytest.raises(ValueError):
        seq_qc_cuda.seq_qc(_seq_decoder(H, "cpu", 4),
                           torch.zeros(H.shape[0], 8, device="meta"), 1.0)
    with pytest.raises(ValueError):
        general_h_cuda.general_h(
            _gh_decoder(_general_matrix("bicycle"), "F", "cpu", 4),
            torch.zeros(73, 8, device="meta"), 1.0)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError):
        _build.nvcc_path()
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError):
        _build.load_all(["channel", "gf2_elim"])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0.01, 0.05])
def test_channel_kernel_equals_plain(cuda_device, p):
    keys = chunk_keys(fold_in(prng_key(0, device=cuda_device), 0), 0, 64)
    before = channel_cuda.LAUNCHES
    kx, kz = channel_cuda.sample_tiles(keys, p, 544, 64)
    px, pz = channel_cuda.sample_tiles_plain(keys, p, 544, 64)
    assert channel_cuda.LAUNCHES == before + 1
    assert kx.shape == (4096, 544) and kx.any()
    assert torch.equal(kx, px) and torch.equal(kz, pz)


def _channel_matrices(name):
    """(Hx, Hz) of a library code, or a seeded random irregular Hz beside
    its rows reversed as Hx: 400 x 1000 of row weights 1 to 24, and 6000 x
    12,000 of row weights 10 to 20, each with a zero-weight row (row 7)."""
    if name not in ("irregular1000", "n12000"):
        c = get_code(name)
        return np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    m, n, lo, hi, seed = {"irregular1000": (400, 1000, 1, 24, 1000),
                          "n12000": (6000, 12000, 10, 20, 12)}[name]
    rng = np.random.default_rng(seed)
    H = np.zeros((m, n), np.int8)
    for i in range(m):
        H[i, rng.choice(n, int(rng.integers(lo, hi + 1)), replace=False)] = 1
    H[7] = 0
    return H[::-1].copy(), H


CHANNEL_PS = [0.0, 1e-4, 0.05, 0.3333333, 1.0]


@pytest.mark.cuda
@pytest.mark.parametrize("B,tile", [(64, 64), (300, 4), (4096, 64),
                                    (33, 1), (1, 1)])   # err_z unaligned
@pytest.mark.parametrize("code", ["lp04_0", "lp118_0", "tanner", "steane",
                                  "shor", "bicycle", "irregular1000",
                                  "n12000"])
def test_fused_channel_kernel_equals_plain(cuda_device, code, B, tile):
    """Kernel A with the syndromes against its plain version, bit for bit on
    err_x, err_z, sy_z and sy_x, one launch a call; the errors-only variant
    against `sample_tiles_plain`."""
    Hx, Hz = _channel_matrices(code)
    n = Hx.shape[1]
    tabs = channel_cuda.SyndromeTables.build(Hx, Hz, device=cuda_device)
    keys = chunk_keys(fold_in(prng_key(2, device=cuda_device), 5), 7,
                      B // tile)
    for p in CHANNEL_PS:
        before = (channel_cuda.LAUNCHES, channel_cuda.SYN_LAUNCHES)
        out = channel_cuda.sample_shot_tiles_cuda(keys, p, n, tile, tabs)
        assert (channel_cuda.LAUNCHES, channel_cuda.SYN_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        ex, ez = channel_cuda.sample_tiles_cuda(keys, p, n, tile)
        assert (channel_cuda.LAUNCHES, channel_cuda.SYN_LAUNCHES) == (
            before[0] + 2, before[1] + 1)
        plain = channel_cuda.sample_shot_tiles_plain(keys, p, n, tile, tabs)
        torch.cuda.synchronize()
        assert out[2].shape == (B, Hz.shape[0]) and out[2].is_contiguous()
        for a, b in zip(out, plain):
            assert torch.equal(a, b), p
        assert torch.equal(ex, plain[0]) and torch.equal(ez, plain[1])
        if p >= 0.05 and B * n >= 1000:   # enough draws to hold an error
            assert out[0].any() and out[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["lp118_0", "tanner", "steane"])
def test_pipeline_sample_chunk_is_one_launch_on_card(cuda_device, code,
                                                     monkeypatch):
    """`ShotPipeline._sample_chunk` on the card launches kernel A once and
    calls no syndrome product; its syndromes equal `syndromes_of` of its
    errors, and everything equals the CPU pipeline's chunk."""
    c = get_code(code)
    Hx, Hz = np.asarray(c.Hx) % 2, np.asarray(c.Hz) % 2
    cfg = SimConfig(shots=4096, dec_type="MS", dec_iterations=4,
                    batch_size=4096, device="cuda")
    pipe = ShotPipeline(Hx, Hz, cfg)
    keys = chunk_keys(fold_in(prng_key(0, device=cuda_device), 0), 0,
                      pipe.tiles_per_chunk)

    def no_product(*args):
        raise AssertionError("syndromes_of called on the fused path")

    with monkeypatch.context() as mp:
        mp.setattr(montecarlo, "syndromes_of", no_product)
        before = (channel_cuda.LAUNCHES, channel_cuda.SYN_LAUNCHES)
        out = pipe._sample_chunk(keys, 0.05)
        assert (channel_cuda.LAUNCHES, channel_cuda.SYN_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
    want = syndromes_of(out[0], out[1], torch.as_tensor(
        Hx.T, dtype=torch.float32, device=cuda_device), torch.as_tensor(
        Hz.T, dtype=torch.float32, device=cuda_device))
    assert torch.equal(out[2], want[0]) and torch.equal(out[3], want[1])
    on_cpu = ShotPipeline(Hx, Hz, dataclasses.replace(cfg, device="cpu")
                          )._sample_chunk(keys.cpu(), 0.05)
    for a, b in zip(out, on_cpu):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_validate_encoding_on_card_leaves_the_counters(cuda_device):
    """With the encoder the channel draws the errors alone (the syndromes
    come from the framed words), and every counter stays."""
    c = get_code("lp04_0")
    cfg = SimConfig(shots=1024, dec_type="MS", dec_iterations=20,
                    dec_schedule="L", batch_size=512, rng_seed=1,
                    device="cuda")
    plain = simulate_p(c.Hx, c.Hz, 0.05, cfg)
    before = (channel_cuda.LAUNCHES, channel_cuda.SYN_LAUNCHES)
    enc = simulate_p(c.Hx, c.Hz, 0.05,
                     dataclasses.replace(cfg, validate_encoding=True))
    assert (channel_cuda.LAUNCHES, channel_cuda.SYN_LAUNCHES) == (
        before[0] + 2, before[1])
    assert enc.counters == plain.counters
    assert enc.avg_iterations_x == plain.avg_iterations_x
    assert enc.avg_iterations_z == plain.avg_iterations_z


@pytest.mark.cuda
@pytest.mark.parametrize("code,sched,B,p_err", [
    ("lp118_0", "L", 300, 0.05), ("lp118_0", "F", 300, 0.05),
    ("tanner", "L", 300, 0.05), ("lp04_0", "F", 300, 0.05),
    ("lp04_0", "L", 300, 0.05),    # lift 7, degree 7
    ("tanner", "F", 129, 0.05),    # lift 31: a warp is no multiple of it
    ("lp118_0", "L", 1, 0.05),     # a lone shot
    ("lp118_0", "L", 4099, 0.05),  # the last block is not full
    ("lp118_0", "L", 64, 0.0),     # zero syndromes: one iteration
    ("lp118_0", "L", 300, 0.2),    # most shots run to the cap
])
def test_ms_qc_kernel_equals_plain(cuda_device, code, sched, B, p_err):
    H = np.asarray(get_code(code).Hz) % 2
    dec = _decoder(H, sched, cuda_device)
    syn_T = _syndromes(7, H, B, p_err, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
    kp, ki, kc = _assert_b_equals_plain(dec, syn_T, lch)
    assert kp.shape == (H.shape[1], B) and kp.T.is_contiguous()
    if p_err == 0.0:
        assert (ki == 1).all() and kc.all() and not (kp < 0).any()
    elif p_err == 0.2:
        assert (ki == dec.max_iter).sum() > B // 2
    elif B > 1:
        assert kc.any() and ki.max() > 1
    # the (m, B) transpose of shot-major syndromes is read as it lies
    vp, vi, vc = ms_qc_cuda.ms_qc_cuda(dec, syn_T.T.contiguous().T, lch)
    assert torch.equal(vp, kp) and torch.equal(vi, ki)


@pytest.mark.cuda
@pytest.mark.parametrize("code,sched,B,p_err", [
    ("lp118_0", "F", 300, 0.05), ("lp118_0", "L", 300, 0.05),
    ("lp04_0", "F", 300, 0.05), ("lp04_0", "L", 300, 0.05),
    ("tanner", "L", 129, 0.05), ("lp118_0", "F", 1, 0.05),
    ("lp118_0", "L", 4099, 0.03), ("lp118_0", "L", 64, 0.0),
    ("lp118_0", "F", 300, 0.2),
])
def test_bp_qc_kernel_equals_plain(cuda_device, code, sched, B, p_err):
    """Kernel B, kind BP: tanhf, logf and IEEE division, as torch's tanh,
    log and `/` on the card, so bit for bit, posterior included."""
    H = np.asarray(get_code(code).Hz) % 2
    dec = _decoder(H, sched, cuda_device, max_iter=30, kind="BP")
    syn_T = _syndromes(8, H, B, p_err, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.03) / np.float32(3.0))
    kp, ki, kc = _assert_b_equals_plain(dec, syn_T, lch)
    if p_err == 0.0:
        assert (ki == 1).all() and kc.all()
    elif p_err == 0.2:
        assert (ki == dec.max_iter).sum() > B // 2
    elif B > 1:
        assert kc.any() and not kc.all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("name,sizes,chk", [
    ("irregular", None, "iter"), ("irregular", None, "layer"),
    ("irregular", "F", "iter"), ("deg12", None, "iter"),
    ("deg12", "F", "iter"), ("deg12", None, "layer"),
    # layer groups of several block-rows that share variable blocks
    ("irregular", (2, 1, 3), "iter"), ("irregular", (2, 1, 3), "layer"),
    ("deg12", (2, 1), "layer"),
])
def test_qc_kernel_synthetic_lifts_equal_plain(cuda_device, kind, name, sizes,
                                               chk):
    """Kernel B on lifted codes with a non-uniform degree, a degree above 8,
    and layer groups that need a snapshot, with both checks."""
    st = _synthetic_lift(name)
    H = st.lift()
    sched = "F" if sizes == "F" else "L"
    layers = None if sizes in (None, "F") else _grouped_layers(st, sizes)
    dec = ms_qc_cuda.make_qc_decoder(
        st, DecoderConfig(dec_type=kind, max_iter=20, schedule=sched,
                          qc_check_every=chk), layers=layers,
        device=cuda_device)
    if isinstance(sizes, tuple):
        assert dec.tabs.group_snap.any() and dec.delta_slots > 0
        assert dec.track_mis == (chk == "layer")
    syn_T = _syndromes(4, H, 200, 0.04, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.04) / np.float32(3.0))
    for per_edge in (False, True):   # the tables' mapping and the other
        dec.per_edge = per_edge
        kp, ki, kc = _assert_b_equals_plain(dec, syn_T, lch)
    assert len(torch.unique(ki)) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("code,sched,chk", [
    ("lp118_0", "L", "iter"), ("lp118_0", "L", "layer"),
    ("lp118_0", "F", "iter"), ("tanner", "L", "layer"),
])
def test_qc_kernel_thread_counts_and_device_state(cuda_device, kind, code,
                                                  sched, chk):
    """Every way kernel B can run gives the plain version's bits: a thread
    per edge (what the tables choose under L) or per check row (under F),
    each also forced on the other schedule, and the variant that keeps the
    shots' state in device memory, forced on a small code."""
    H = np.asarray(get_code(code).Hz) % 2
    dec = _decoder(H, sched, cuda_device, 30, kind, chk=chk)
    assert not dec.state_on_device
    assert dec.per_edge == (sched == "L") and dec.threads == 256
    syn_T = _syndromes(7, H, 150, 0.05, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
    for on_device in (False, True):
        dec.state_on_device = on_device
        for per_edge in (sched == "L", sched != "L"):
            dec.per_edge = per_edge
            _assert_b_equals_plain(dec, syn_T, lch)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_qc_kernels_state_beyond_shared_memory(cuda_device, kind):
    """A lifted code whose per-shot state exceeds a block's shared memory
    decodes on the card as it does on the CPU: the tables choose the
    device-memory variant of kernels B and D when the decoder is built."""
    st = _synthetic_lift("oversize")
    H = st.lift()
    cfg = DecoderConfig(dec_type=kind, max_iter=6, schedule="F")
    dec = ms_qc_cuda.make_qc_decoder(st, cfg, device=cuda_device,
                                     stacked=True)
    assert not dec.stacked and dec.state_on_device
    syn_T = _syndromes(6, H, 40, 0.01, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.03) / np.float32(3.0))
    _assert_b_equals_plain(dec, syn_T, lch)
    seq = seq_qc_cuda.make_seq_qc_decoder(
        st, dataclasses.replace(cfg, schedule="S", max_iter=3),
        device=cuda_device, kind=kind)
    assert seq.state_on_device
    kp, ki, kc = seq_qc_cuda.seq_qc(seq, syn_T, lch)
    pp, pi, pc = seq_qc_cuda.seq_qc_plain_blockrow(seq, syn_T, lch)
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    assert torch.equal(kp, pp) and kc.any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("code,side,B,max_iter", [
    ("lp118_0", "Hz", 4096, 4),    # config 5's shape, the cascade's head
    ("lp118_0", "Hx", 300, 99),    # full depth
    ("lp04_0", "Hz", 300, 30),     # d = 7: the odd branch of the tree
    ("tanner", "Hz", 129, 30),     # lift 31, 465 check rows
    ("lp118_0", "Hz", 1, 50),      # a lone shot
])
def test_flood_qc_kernel_equals_plain(cuda_device, kind, code, side, B,
                                      max_iter):
    """Kernel F against its plain version: n_iter, converged and the
    estimate equal, the posterior bit for bit (the kernel sums a variable's
    deltas in the plain version's order; BP calls tanhf, logf and IEEE
    division as torch does on the card)."""
    H = np.asarray(getattr(get_code(code), side)) % 2
    dec = _decoder(H, "F", cuda_device, max_iter, kind, stacked=True)
    assert dec.stacked
    syn = _syndromes(9, H, B, 0.04, cuda_device)
    lch = ms_qc_cuda.llr_prior(np.float32(0.03) / np.float32(3.0))
    before = dict(flood_qc_cuda.LAUNCHES)
    kp, ki, kc = flood_qc_cuda.flood_qc(dec, syn, lch)
    pp, pi, pc = flood_qc_cuda.flood_qc_plain(dec, syn, lch)
    assert flood_qc_cuda.LAUNCHES == dict(before, **{kind: before[kind] + 1})
    assert kp.shape == (B, H.shape[1]) and kp.is_contiguous()
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    assert torch.equal(kp < 0, pp < 0)
    assert torch.equal(kp, pp)
    assert B == 1 or kc.any()
    # through the decoder module, on the card: the kernel, not kernel B
    b_before = dict(ms_qc_cuda.LAUNCHES)
    out = dec(syn.to(torch.int8), np.float32(0.03) / np.float32(3.0))
    assert ms_qc_cuda.LAUNCHES == b_before
    assert torch.equal(out.posterior, kp) and torch.equal(out.n_iter, ki)


def _assert_f_equals_plain(dec, syn, lch):
    """Kernel F under the decoder's mapping against its plain version:
    n_iter, converged and the posterior bit for bit."""
    before = dict(flood_qc_cuda.LAUNCHES)
    kp, ki, kc = flood_qc_cuda.flood_qc_cuda(dec, syn, lch)
    pp, pi, pc = flood_qc_cuda.flood_qc_plain(dec, syn, lch)
    torch.cuda.synchronize()
    assert flood_qc_cuda.LAUNCHES == dict(
        before, **{dec.kind: before[dec.kind] + 1})
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    assert torch.equal(kp, pp)
    return kp, ki, kc


# threads of a block that takes kernel F's check rows in several passes and
# its variables beyond the 3 a thread keeps in registers, as the block of a
# code of more than 1024 check rows or 3072 variables does
_F_SMALL_BLOCK = 64


@pytest.mark.cuda
@pytest.mark.parametrize("small_block", [False, True])
@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("case", ["zeros", "p0.2", "deg12"])
def test_flood_qc_kernel_more_shapes_equal_plain(cuda_device, case, kind,
                                                 small_block):
    """Kernel F with the plan's block and with a 64-thread one (rows in
    several passes, variables beyond registers): zero syndromes (every shot
    converges after its first iteration), p = 0.2 (every shot runs to the
    cap) and a synthetic lift of uniform degree 12, bit for bit."""
    if case == "deg12":
        st = _synthetic_lift("deg12")
        dec = ms_qc_cuda.make_qc_decoder(
            st, DecoderConfig(dec_type=kind, max_iter=30, schedule="F"),
            device=cuda_device, stacked=True)
        H = dec.H.cpu().numpy().astype(np.int64)
    else:
        H = np.asarray(get_code("lp118_0").Hz) % 2
        dec = _decoder(H, "F", cuda_device, 20, kind, stacked=True)
    assert dec.stacked
    if small_block:
        dec.flood_threads = _F_SMALL_BLOCK
    p_err = {"zeros": 0.0, "p0.2": 0.2, "deg12": 0.04}[case]
    syn = _syndromes(11, H, 130, p_err, cuda_device)
    lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
    kp, ki, kc = _assert_f_equals_plain(dec, syn, lch)
    if case == "zeros":
        assert (ki == 1).all() and kc.all()
    elif case == "p0.2":
        assert (ki == dec.max_iter).float().mean() > 0.9
    else:
        assert kc.any() and (ki > 1).any()


@pytest.mark.cuda
def test_flood_qc_state_beyond_shared_memory_raises(cuda_device):
    """A shot's state that does not fit a block's shared memory: the decoder
    module does not select kernel F for it, and the wrapper, called on such
    a decoder all the same, raises a ValueError that names the size;
    nothing falls back."""
    st = _synthetic_lift("oversize")
    dec = ms_qc_cuda.make_qc_decoder(st, DecoderConfig(schedule="F"),
                                     device=cuda_device, stacked=True)
    assert not dec.stacked
    assert flood_qc_cuda.smem_bytes(dec.tabs) > 232448
    for name, a in flood_qc_cuda.stacked_tables(dec.tabs).items():
        setattr(dec, f"flood_{name}", torch.as_tensor(a, device=cuda_device))
    with pytest.raises(ValueError, match="bytes of shared memory"):
        flood_qc_cuda.flood_qc(dec, torch.zeros((2, st.m),
                                                device=cuda_device), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("code,B,max_iter", [
    ("lp118_0", 4096, 6), ("lp118_0", 300, 50), ("lp04_0", 300, 30),
    ("tanner", 129, 20), ("lp118_0", 1, 50), ("lp118_0", 4099, 4),
])
def test_qc_kernel_check_every_layer_equals_plain(cuda_device, kind, code, B,
                                                  max_iter):
    """Kernel B with one convergence check after every layer group against
    its plain version, bit for bit; some shot stops elsewhere than with one
    check per iteration."""
    H = np.asarray(get_code(code).Hz) % 2
    dec = _decoder(H, "L", cuda_device, max_iter, kind, chk="layer")
    assert dec.track_mis
    syn_T = _syndromes(7, H, B, 0.05, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
    kp, ki, kc = _assert_b_equals_plain(dec, syn_T, lch)
    if B > 1:
        assert kc.any()
        ip = ms_qc_cuda.ms_qc(_decoder(H, "L", cuda_device, max_iter, kind),
                              syn_T, lch)[0]
        assert not torch.equal(ip, kp)
    zeros = torch.zeros_like(syn_T[:, :8])
    zp, zi, zc = _assert_b_equals_plain(dec, zeros, lch)
    assert (zi == 1).all() and zc.all()


@pytest.mark.cuda
@pytest.mark.parametrize("code,B,max_iter,p_err", [
    ("lp04_0", 300, 30, 0.05),     # small shape, full depth
    ("lp118_0", 300, 8, 0.04),     # lift 16
    ("tanner", 4096, 3, 0.047),    # the main path's shape (config 4 chunk)
    ("tanner", 128, 16, 0.047),    # the main path's last-stage window
    ("tanner", 1, 30, 0.047),      # a lone shot
    ("tanner", 4099, 2, 0.047),    # the last block is not full
    ("lp04_0", 300, 6, 0.2),       # most shots run to the cap
    ("lp118_0", 64, 8, 0.0),       # zero syndromes: row 0 alone
])
@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_seq_qc_kernel_equals_plain(cuda_device, kind, code, B, max_iter,
                                    p_err):
    """Kernel D against its plain version, both sides of the code: n_iter
    and converged equal, and the posterior equal by value on every element
    (tolerance 0; `torch.equal` takes -0.0 == 0.0, which a thread that left
    its loops keeps where the plain version's masked update stores +0.0)."""
    code_ = get_code(code)
    for H in (np.asarray(code_.Hz) % 2, np.asarray(code_.Hx) % 2):
        dec = _seq_decoder(H, cuda_device, max_iter, kind)
        syn_T = _syndromes(12, H, B, p_err, cuda_device).T.contiguous()
        if B > 1:
            syn_T[:, 0] = 0.0       # a zero syndrome: one row, n_iter == 1
        lch = ms_qc_cuda.llr_prior(np.float32(0.07) / np.float32(3.0))
        before = dict(seq_qc_cuda.LAUNCHES)
        kp, ki, kc = seq_qc_cuda.seq_qc(dec, syn_T, lch)
        pp, pi, pc = seq_qc_cuda.seq_qc_plain(dec, syn_T, lch)
        assert seq_qc_cuda.LAUNCHES == dict(before, **{kind: before[kind] + 1})
        if B > 1:
            assert int(ki[0]) == 1 and bool(kc[0])
            assert not (kp[:, 0] < 0).any()
        if p_err == 0.0:
            assert (ki == 1).all() and kc.all()
        elif p_err == 0.2:
            assert (ki == max_iter).sum() > B // 2
        elif B > 1:
            assert kc.any() and ki.max() > 1
        assert torch.equal(ki, pi) and torch.equal(kc, pc)
        assert torch.equal(kp < 0, pp < 0)
        assert torch.equal(kp, pp)
        # the block-row formulation in plain PyTorch gives the same
        bp_, bi, bc = seq_qc_cuda.seq_qc_plain_blockrow(dec, syn_T, lch)
        assert torch.equal(bi, pi) and torch.equal(bc, pc)
        assert torch.equal(bp_, pp)
        # the variant with the shots' state in device memory, forced
        dec.state_on_device = True
        gp, gi, gc = seq_qc_cuda.seq_qc(dec, syn_T, lch)
        assert torch.equal(gi, pi) and torch.equal(gc, pc)
        assert torch.equal(gp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("name", ["irregular", "deg12"])
def test_seq_qc_kernel_synthetic_lifts_equal_plain(cuda_device, kind, name):
    """Kernel D on lifted codes with a non-uniform degree and with a degree
    above 8."""
    st = _synthetic_lift(name)
    H = st.lift()
    dec = seq_qc_cuda.make_seq_qc_decoder(
        st, DecoderConfig(dec_type=kind, max_iter=12, schedule="S"),
        device=cuda_device, kind=kind)
    syn_T = _syndromes(4, H, 200, 0.04, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.04) / np.float32(3.0))
    kp, ki, kc = seq_qc_cuda.seq_qc(dec, syn_T, lch)
    pp, pi, pc = seq_qc_cuda.seq_qc_plain(dec, syn_T, lch)
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    assert torch.equal(kp, pp) and len(torch.unique(ki)) >= 2


def _assert_e_equals_plain(dec, syn_T, lch):
    """Kernel E against its plain version under both mappings (where the
    rows fit a thread per edge) and with the state in shared and in device
    memory: n_iter and converged equal, the posterior equal by value on
    every element (tolerance 0; == takes -0.0 and 0.0 as equal). Returns the
    kernel's (posterior, n_iter, converged) under the tables' choices."""
    pp, pi, pc = general_h_cuda.general_h_plain(dec, syn_T, lch)
    chosen = (dec.per_edge, dec.state_on_device)
    # a state beyond shared memory has one place; rows of more than 32
    # slots one mapping
    places = (True,) if chosen[1] else (False, True)
    mappings = (chosen[0], not chosen[0]) if dec.tabs.dmax <= 32 else (False,)
    out = None
    for on_device in places:
        for per_edge in mappings:
            dec.state_on_device, dec.per_edge = on_device, per_edge
            before = dict(general_h_cuda.LAUNCHES)
            kp, ki, kc = general_h_cuda.general_h(dec, syn_T, lch)
            torch.cuda.synchronize()
            assert general_h_cuda.LAUNCHES == dict(
                before, **{dec.kind: before[dec.kind] + 1})
            what = (per_edge, on_device)
            assert torch.equal(ki, pi) and torch.equal(kc, pc), what
            assert torch.equal(kp < 0, pp < 0), what
            assert torch.equal(kp, pp), what
            if (per_edge, on_device) == chosen:
                out = (kp, ki, kc)
    dec.per_edge, dec.state_on_device = chosen
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("B,max_iter", [(1, 20), (33, 20), (4096, 4)])
@pytest.mark.parametrize("name", ["lp118_perm", "bicycle", "irregular",
                                  "steane", "wide"])
@pytest.mark.parametrize("sched", ["L", "F"])
@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_general_h_kernel_equals_plain(cuda_device, kind, sched, name, B,
                                       max_iter):
    """Kernel E against its plain version, tolerance 0, under both
    mappings and both places of the state: under L each posterior entry
    takes one delta per layer, under F both sum a variable's deltas in
    ascending edge order from 0; BP through the CUDA math library's tanhf
    and logf on both sides. The first shot has a zero syndrome."""
    H = _general_matrix(name)
    dec = _gh_decoder(H, sched, cuda_device, max_iter, kind)
    syn_T = _syndromes(3, H, B, 0.01 if name == "bicycle" else 0.017,
                       cuda_device).T.contiguous()
    if B > 1:
        syn_T[:, 0] = 0.0           # a zero syndrome: one iteration
    lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
    kp, ki, kc = _assert_e_equals_plain(dec, syn_T, lch)
    if B > 1:
        assert int(ki[0]) == 1 and bool(kc[0]) and not (kp[:, 0] < 0).any()
        assert kc.any() and (ki.max() > 1 or name == "steane")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("case", ["p0.2 L", "p0.2 F", "caller layers",
                                  "oversize L", "oversize F"])
def test_general_h_kernel_more_shapes_equal_plain(cuda_device, kind, case):
    """Kernel E at p = 0.2 (most shots at the cap), under caller layers of
    two rows whose rows share variables (a snapshot under L), and on a
    matrix whose state the tables put in device memory (3000 x 6000, its
    tables too large for shared memory as well): both mappings, tolerance
    0."""
    lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
    if case.startswith("p0.2"):
        H = _general_matrix("lp118_perm")
        dec = _gh_decoder(H, case[-1], cuda_device, 20, kind)
        syn_T = _syndromes(5, H, 300, 0.2, cuda_device).T.contiguous()
    elif case == "caller layers":
        H = _general_matrix("irregular")
        m = H.shape[0]
        layers = LayerSchedule.from_layers(
            [np.arange(i, i + 2) for i in range(0, m, 2)], m)
        dec = general_h_cuda.make_gh_decoder(
            H, DecoderConfig(dec_type=kind, max_iter=20, schedule="L"),
            layers=layers, device=cuda_device, kind=kind)
        assert 0 < int(dec.tabs.run_shared.sum()) < len(dec.tabs.runs)
        syn_T = _syndromes(6, H, 200, 0.017, cuda_device).T.contiguous()
    else:
        H = _general_matrix("oversize")
        dec = _gh_decoder(H, case[-1], cuda_device, 4, kind)
        assert dec.state_on_device and not dec.tables_in_shared
        syn_T = _syndromes(6, H, 8, 0.002, cuda_device).T.contiguous()
    kp, ki, kc = _assert_e_equals_plain(dec, syn_T, lch)
    if case.startswith("p0.2"):
        assert (ki == dec.max_iter).float().mean() > 0.5 and not kc.all()
    elif case == "caller layers":
        assert len(torch.unique(ki)) >= 2


@pytest.mark.cuda
def test_general_h_path_on_card_equals_cpu(cuda_device):
    """Min-sum, layered, on the column-permuted lp118_0 through
    `simulate_p`: the card's counters equal the CPU's, through kernel E and
    neither QC kernel."""
    perm = np.random.default_rng(118).permutation(544)
    c = get_code("lp118_0")
    Hx = (np.asarray(c.Hx) % 2)[:, perm]
    Hz = (np.asarray(c.Hz) % 2)[:, perm]
    cfg = SimConfig(shots=1000, dec_type="MS", dec_iterations=50,
                    dec_schedule="L", batch_size=512, rng_seed=3,
                    device="cpu")
    on_cpu = simulate_p(Hx, Hz, 0.05, cfg)
    before = (dict(general_h_cuda.LAUNCHES), dict(ms_qc_cuda.LAUNCHES),
              dict(seq_qc_cuda.LAUNCHES))
    on_card = simulate_p(Hx, Hz, 0.05,
                         dataclasses.replace(cfg, device="cuda"))
    assert general_h_cuda.LAUNCHES["MS"] >= before[0]["MS"] + 4
    assert ms_qc_cuda.LAUNCHES == before[1]
    assert seq_qc_cuda.LAUNCHES == before[2]
    assert on_card.counters == on_cpu.counters
    assert on_card.avg_iterations_x == on_cpu.avg_iterations_x
    assert on_card.avg_iterations_z == on_cpu.avg_iterations_z


@pytest.mark.cuda
@pytest.mark.parametrize("code,kw", [
    ("steane", dict(dec_type="MS", dec_iterations=50, dec_schedule="L")),
    ("bicycle", dict(dec_type="BF")),
    ("bicycle", dict(dec_type="NG")),
])
def test_small_codes_on_card_equal_cpu(cuda_device, code, kw):
    """The plain-torch decoders of configs 2 and 3 on the card: integer
    arithmetic (BF, NG) or one delta per variable and layer (Steane MS-L),
    so the counters equal the CPU's."""
    c = get_code(code)
    cfg = SimConfig(shots=1024, batch_size=512, rng_seed=1, device="cpu",
                    **kw)
    on_cpu = simulate_p(c.Hx, c.Hz, 0.03, cfg)
    on_card = simulate_p(c.Hx, c.Hz, 0.03,
                         dataclasses.replace(cfg, device="cuda"))
    assert on_card.counters == on_cpu.counters
    assert on_card.avg_iterations_x == on_cpu.avg_iterations_x


@pytest.mark.cuda
def test_unwritable_build_dir_raises_on_cuda_tensor(cuda_device, monkeypatch,
                                                    tmp_path):
    """A CUDA tensor launches the kernel or raises: with nowhere to build
    the kernel (neither the default directory nor the per-user cache can be
    created), the wrapper raises and does not fall back to the plain
    version."""
    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    monkeypatch.setattr(_build, "BUILD_DIR", blocked / "build")
    monkeypatch.delenv(_build.BUILD_DIR_ENV, raising=False)
    monkeypatch.setenv("HOME", str(blocked / "home"))
    monkeypatch.setattr(_build, "_LIBS", {})
    H = np.asarray(get_code("lp04_0").Hz) % 2
    dec = _seq_decoder(H, cuda_device, 4)
    syn_T = _syndromes(13, H, 64, 0.05, cuda_device).T.contiguous()
    before = dict(seq_qc_cuda.LAUNCHES)
    with pytest.raises(OSError):
        seq_qc_cuda.seq_qc(dec, syn_T, 4.0)
    assert seq_qc_cuda.LAUNCHES == before


@pytest.mark.cuda
def test_config4_on_card_equals_cpu(cuda_device):
    """Serial min-sum on the Tanner code through `simulate_p`: the card's
    counters equal the CPU's (MS is bit-exact across devices), through
    kernel D and not kernel B."""
    c = get_code("tanner")
    cfg = SimConfig(shots=192, dec_type="MS", dec_iterations=30,
                    dec_schedule="S", batch_size=64, rng_seed=5,
                    device="cpu")
    on_cpu = simulate_p(c.Hx, c.Hz, 0.04, cfg)
    seq_before = seq_qc_cuda.LAUNCHES["MS"]
    b_before = dict(ms_qc_cuda.LAUNCHES)
    on_card = simulate_p(c.Hx, c.Hz, 0.04,
                         dataclasses.replace(cfg, device="cuda"))
    assert seq_qc_cuda.LAUNCHES["MS"] >= seq_before + 6
    assert ms_qc_cuda.LAUNCHES == b_before
    assert on_card.counters == on_cpu.counters
    assert on_card.avg_iterations_x == on_cpu.avg_iterations_x
    assert on_card.avg_iterations_z == on_cpu.avg_iterations_z


@pytest.mark.cuda
@pytest.mark.parametrize("code,B", [("lp118_0", 300), ("lp04_0", 64)])
def test_gf2_elim_kernel_equals_plain(cuda_device, code, B):
    st, colsP = _permuted_columns(code, B, 9, cuda_device)
    before = gf2_elim_cuda.LAUNCHES
    kt, kp, ks = gf2_elim_cuda.eliminate(colsP, st.r, st.rW)
    pt, pp, ps = gf2_elim_cuda.eliminate_plain(colsP, st.r, st.rW)
    assert gf2_elim_cuda.LAUNCHES == before + 1
    assert (kp >= 0).all() and (ks.sum(dim=1) == st.r).all()
    assert torch.equal(kt, pt) and torch.equal(kp, pp) and torch.equal(ks, ps)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("B", [1, 33, 256, 300])
@pytest.mark.parametrize("code", ["lp118_0", "lp04_0", "tanner"])
def test_gf2_elim_kernel_shapes_and_mappings_equal_plain(cuda_device, code, B,
                                                         pairs):
    """Kernel C under both mappings (a thread per basis row; a thread per
    (row, word) pair) against its plain version: tags, pivots and sel bit
    for bit, on random column orders of the library codes (all of rank
    below m) and of [H | H], whose every column has a dependent twin."""
    H = np.asarray(get_code(code).Hz) % 2
    st, colsP = _elim_window(H, B, 40 + B, cuda_device)
    pl = _assert_c_equals_plain(st, colsP, pairs)
    assert not pl.state_on_device and (pl.lanes > 1) == pairs
    st, colsP = _elim_window(H, B, 41 + B, cuda_device, doubled=True)
    _assert_c_equals_plain(st, colsP, pairs)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
def test_gf2_elim_kernel_basis_in_device_memory_equals_plain(cuda_device,
                                                             pairs):
    """A basis beyond a block's shared memory (1200 checks, 77-word rows):
    before kernel C's redesign the launch was refused; now the basis lies in
    device memory and the outputs equal the plain version's. Also the
    small codes with the basis forced into device memory."""
    st, colsP = _elim_window(_oversize_check_matrix(), 6, 43, cuda_device)
    pl = _assert_c_equals_plain(st, colsP, pairs)
    # the launch before the redesign asked for r (mW + rW) + 32 mW words
    assert pl.state_on_device
    assert 4 * (st.r * (st.mW + st.rW) + 32 * st.mW) > 232448
    st, colsP = _elim_window(np.asarray(get_code("lp118_0").Hz) % 2, 33, 44,
                             cuda_device)
    forced = dataclasses.replace(
        gf2_elim_cuda.plan(st.r, st.mW, st.rW, pairs=pairs),
        state_on_device=True)
    kt, kp, ks = gf2_elim_cuda.eliminate_cuda(colsP, st.r, st.rW, forced)
    pt, pp, ps = gf2_elim_cuda.eliminate_plain(colsP, st.r, st.rW)
    assert torch.equal(kt, pt) and torch.equal(kp, pp) and torch.equal(ks, ps)


@pytest.mark.cuda
def test_osd_with_basis_in_device_memory_on_card_equals_cpu(cuda_device):
    """OSD-2 on a parity-check matrix of 1200 checks: on the card (kernel C,
    its basis in the module's device-memory scratch) the same estimates as
    on the CPU. Before kernel C's redesign the card raised here."""
    H = _oversize_check_matrix()
    n = H.shape[1]
    rng = np.random.default_rng(13)
    e_hat = torch.from_numpy((rng.random((6, n)) < 0.02).astype(np.int8))
    syn = torch.from_numpy(((rng.random((6, n)) < 0.02).astype(np.int64)
                            @ H.T % 2).astype(np.float32))
    mags = np.stack([rng.permutation(n) + 1 for _ in range(6)])
    signs = rng.choice([-1.0, 1.0], size=mags.shape)
    post = torch.from_numpy((signs * mags * (8.0 / n)).astype(np.float32))
    on_cpu = OSD(H, 2)(e_hat, syn, post)
    osd = OSD(H, 2, device=cuda_device)
    assert osd.elim_plan.state_on_device
    before = gf2_elim_cuda.LAUNCHES
    on_card = osd(e_hat.to(cuda_device), syn.to(cuda_device),
                  post.to(cuda_device))
    assert gf2_elim_cuda.LAUNCHES == before + 1
    assert torch.equal(on_card.cpu(), on_cpu)
    assert osd.elim_scratch(6, cuda_device).numel() \
        == 6 * osd.r * osd.elim_plan.stride


@pytest.mark.cuda
def test_osd_on_card_equals_cpu(cuda_device):
    """OSD-2 over the same inputs on the card (kernel C) and on the CPU
    (plain elimination): the same estimates."""
    H = np.asarray(get_code("lp118_0").Hz) % 2
    rng = np.random.default_rng(10)
    e_hat = torch.from_numpy((rng.random((100, H.shape[1])) < 0.05)
                             .astype(np.int8))
    syn = torch.from_numpy(((rng.random((100, H.shape[1])) < 0.05)
                            .astype(np.int64) @ H.T % 2).astype(np.float32))
    # posteriors of distinct magnitudes up to 8, 8/544 apart: their
    # reliabilities lie far more than exp's last-ulp differences between
    # the devices apart, so both devices order the columns alike (equal
    # magnitudes of opposite sign would tie only up to that ulp)
    mags = np.stack([rng.permutation(H.shape[1]) + 1 for _ in range(100)])
    signs = rng.choice([-1.0, 1.0], size=mags.shape)
    post = torch.from_numpy((signs * mags * (8.0 / H.shape[1]))
                            .astype(np.float32))
    on_cpu = OSD(H, 2)(e_hat, syn, post)
    before = gf2_elim_cuda.LAUNCHES
    on_card = OSD(H, 2, device=cuda_device)(
        e_hat.to(cuda_device), syn.to(cuda_device), post.to(cuda_device))
    assert gf2_elim_cuda.LAUNCHES == before + 1
    assert torch.equal(on_card.cpu(), on_cpu)


@pytest.mark.cuda
def test_simulate_p_on_card_equals_cpu(cuda_device):
    c = get_code("lp118_0")
    cfg = SimConfig(shots=1000, dec_type="MS", dec_iterations=50,
                    dec_schedule="L", batch_size=512, rng_seed=3,
                    device="cpu")
    on_cpu = simulate_p(c.Hx, c.Hz, 0.05, cfg)
    launches = (channel_cuda.LAUNCHES, ms_qc_cuda.LAUNCHES["MS"])
    on_card = simulate_p(c.Hx, c.Hz, 0.05,
                         dataclasses.replace(cfg, device="cuda"))
    assert channel_cuda.LAUNCHES == launches[0] + 2
    assert ms_qc_cuda.LAUNCHES["MS"] >= launches[1] + 4
    assert on_card.counters == on_cpu.counters
    assert on_card.avg_iterations_x == on_cpu.avg_iterations_x
    assert on_card.avg_iterations_z == on_cpu.avg_iterations_z


@pytest.mark.cuda
@pytest.mark.parametrize("osd_order", [-1, 2])
def test_two_slot_mesh_on_one_card_equals_the_unmeshed_run(cuda_device,
                                                           osd_order):
    """A 2-slot mesh of one card (a host thread per slot) gives the
    unmeshed run's counters, each slot launching kernel A once a chunk."""
    from qldpcsim_torch.parallel.mesh import make_mesh

    c = get_code("lp04_0")
    cfg = SimConfig(shots=1000, dec_type="MS", dec_iterations=30,
                    dec_schedule="L", osd_order=osd_order, batch_size=512,
                    rng_seed=3, device="cuda")
    whole = simulate_p(c.Hx, c.Hz, 0.08, cfg)
    before = channel_cuda.LAUNCHES
    meshed = simulate_p(c.Hx, c.Hz, 0.08, dataclasses.replace(
        cfg, mesh=make_mesh(["cuda:0", "cuda:0"])))
    assert channel_cuda.LAUNCHES == before + 4  # 2 chunks x 2 slots
    assert meshed.counters == whole.counters
    assert meshed.avg_iterations_x == whole.avg_iterations_x


@pytest.mark.cuda
def test_launch_on_the_current_card_passes_the_device_check(cuda_device):
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.require_current(dev)
    keys = chunk_keys(fold_in(prng_key(1, device=dev), 0), 0, 2)
    before = channel_cuda.LAUNCHES
    channel_cuda.sample_tiles_cuda(keys, 0.05, 84, 64)
    assert channel_cuda.LAUNCHES == before + 1


# --- the bf16 state (kernels B and F) and the stacked-update writeback
# (kernel B) against their plain versions, bit for bit

BF16 = torch.bfloat16


def _qc(st_or_H, sched, device, max_iter, kind="MS", chk="iter",
        layers=None, **kw):
    st = st_or_H if isinstance(st_or_H, QCStructure) else detect_qc(st_or_H)
    if layers is None and not isinstance(st_or_H, QCStructure):
        layers = build_layers(st_or_H, sched)
    return ms_qc_cuda.make_qc_decoder(
        st, DecoderConfig(dec_type=kind, max_iter=max_iter, schedule=sched,
                          qc_check_every=chk),
        layers=layers, device=device, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("code,sched,B,p_err", [
    ("lp118_0", "L", 4096, 0.05),  # the flagship's shape
    ("lp118_0", "F", 4096, 0.03),  # config 5's
    ("lp118_0", "L", 1, 0.05), ("lp118_0", "L", 4099, 0.05),
    ("lp118_0", "L", 64, 0.0), ("lp118_0", "F", 300, 0.2),
    ("tanner", "L", 300, 0.05), ("tanner", "F", 129, 0.05),
    ("lp04_0", "F", 300, 0.05), ("lp04_0", "L", 300, 0.05),
])
def test_bf16_qc_kernel_equals_plain(cuda_device, kind, code, sched, B,
                                     p_err):
    """Kernel B with the bf16 state, under the mapping its tables choose and
    the other one, bit for bit with its plain version (posterior included);
    every posterior word is a bf16 value."""
    H = np.asarray(get_code(code).Hz) % 2
    dec = _qc(H, sched, cuda_device, 50 if kind == "MS" else 30, kind,
              dtype=BF16, vec=False)
    assert dec.state_dtype == BF16 and not dec.state_on_device
    syn_T = _syndromes(7, H, B, p_err, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
    chosen = dec.per_edge
    for per_edge in (chosen, not chosen):
        dec.per_edge = per_edge
        kp, ki, kc = _assert_b_equals_plain(dec, syn_T, lch)
    assert torch.equal(kp, kp.to(BF16).float())
    if p_err == 0.0:
        assert (ki == 1).all() and kc.all()
    elif B > 1 and p_err < 0.2:
        assert kc.any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("name,sizes,chk", [
    ("irregular", None, "iter"), ("irregular", None, "layer"),
    ("irregular", "F", "iter"), ("deg12", "F", "iter"),
    ("deg12", None, "layer"), ("irregular", (2, 1, 3), "iter"),
    ("irregular", (2, 1, 3), "layer"), ("deg12", (2, 1), "layer"),
])
def test_bf16_qc_kernel_lifts_mappings_and_device_state(cuda_device, kind,
                                                        name, sizes, chk):
    """Kernel B in bf16 on the synthetic lifts (odd sizes, degree 12,
    snapshot groups, the per-layer check), both mappings and both places
    of the state."""
    st = _synthetic_lift(name)
    H = st.lift()
    sched = "F" if sizes == "F" else "L"
    layers = None if sizes in (None, "F") else _grouped_layers(st, sizes)
    dec = _qc(st, sched, cuda_device, 20, kind, chk, layers=layers,
              dtype=BF16, vec=False)
    syn_T = _syndromes(4, H, 200, 0.04, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.04) / np.float32(3.0))
    for on_device in (False, True):
        dec.state_on_device = on_device
        for per_edge in (False, True):
            dec.per_edge = per_edge
            kp, ki, kc = _assert_b_equals_plain(dec, syn_T, lch)
    assert len(torch.unique(ki)) >= 2


def _bf16_only_lift():
    """A lift whose float32 state needs device memory under kernel B and is
    too large for kernel F, while its bf16 state fits a block in both."""
    L, m_b, n_b, deg = 128, 27, 8, 8
    shifts = np.full((m_b, n_b), -1)
    for i in range(m_b):
        shifts[i, [(3 * i + t) % n_b for t in range(deg)]] = [
            (i + 2 * t) % L for t in range(deg)]
    return QCStructure(L=L, shifts=shifts)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_bf16_lift_that_fits_only_in_bf16(cuda_device, kind):
    st = _bf16_only_lift()
    H = st.lift()
    syn = _syndromes(6, H, 64, 0.002, cuda_device)
    lch = ms_qc_cuda.llr_prior(np.float32(0.01) / np.float32(3.0))
    b32 = _qc(st, "F", cuda_device, 6, kind, dtype=torch.float32,
              stacked=False)
    b16 = _qc(st, "F", cuda_device, 6, kind, dtype=BF16, stacked=False)
    assert b32.state_on_device and not b16.state_on_device
    _assert_b_equals_plain(b16, syn.T.contiguous(), lch)
    f16 = _qc(st, "F", cuda_device, 6, kind, dtype=BF16, stacked=True)
    assert f16.stacked
    assert not _qc(st, "F", cuda_device, 6, kind, dtype=torch.float32,
                   stacked=True).stacked
    _assert_f_equals_plain(f16, syn, lch)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["MS", "BP"])
@pytest.mark.parametrize("code,side,B,max_iter,small_block", [
    ("lp118_0", "Hz", 4096, 99, False),   # config 5's shape
    ("lp118_0", "Hz", 4096, 4, True),
    ("lp118_0", "Hx", 300, 99, False),
    ("lp04_0", "Hz", 300, 30, False),     # d = 7, odd sizes
    ("tanner", "Hz", 129, 30, False),
    ("tanner", "Hz", 129, 30, True),
    ("lp118_0", "Hz", 1, 50, False),
])
def test_bf16_flood_qc_kernel_equals_plain(cuda_device, kind, code, side, B,
                                           max_iter, small_block):
    H = np.asarray(getattr(get_code(code), side)) % 2
    dec = _qc(H, "F", cuda_device, max_iter, kind, dtype=BF16, stacked=True)
    assert dec.stacked and dec.state_dtype == BF16
    if small_block:
        dec.flood_threads = _F_SMALL_BLOCK
    syn = _syndromes(9, H, B, 0.04, cuda_device)
    lch = ms_qc_cuda.llr_prior(np.float32(0.03) / np.float32(3.0))
    kp, ki, kc = _assert_f_equals_plain(dec, syn, lch)
    assert torch.equal(kp, kp.to(BF16).float())
    assert B == 1 or kc.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("code,sched,B,p_err", [
    ("lp118_0", "F", 4096, 0.05), ("lp118_0", "L", 4096, 0.05),
    ("lp118_0", "L", 1, 0.05), ("lp118_0", "F", 4099, 0.05),
    ("lp118_0", "L", 64, 0.0), ("lp118_0", "L", 300, 0.2),
    ("tanner", "L", 300, 0.05), ("lp04_0", "F", 300, 0.05),
])
def test_vec_qc_kernel_equals_plain(cuda_device, dtype, code, sched, B,
                                    p_err):
    """Kernel B with the stacked-update writeback (MS, one check per
    iteration): every lane of either mapping adds the delta fma(coef *
    sign, mag, -R) and stores R + delta, bit for bit with the plain
    version, with the state in shared and in device memory."""
    H = np.asarray(get_code(code).Hz) % 2
    dec = _qc(H, sched, cuda_device, 50, dtype=dtype, vec=True)
    assert dec.vec
    syn_T = _syndromes(7, H, B, p_err, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
    chosen = dec.per_edge
    for on_device in (False, True):
        dec.state_on_device = on_device
        for per_edge in (chosen, not chosen):
            dec.per_edge = per_edge
            _assert_b_equals_plain(dec, syn_T, lch)


@pytest.mark.cuda
def test_vec_on_synthetic_lifts_equals_plain(cuda_device):
    for name, sizes in (("irregular", None), ("deg12", "F"),
                        ("irregular", (2, 1, 3))):
        st = _synthetic_lift(name)
        sched = "F" if sizes == "F" else "L"
        layers = None if sizes in (None, "F") else _grouped_layers(st, sizes)
        dec = _qc(st, sched, cuda_device, 20, layers=layers, vec=True)
        assert dec.vec
        syn_T = _syndromes(4, st.lift(), 200, 0.04,
                           cuda_device).T.contiguous()
        lch = ms_qc_cuda.llr_prior(np.float32(0.04) / np.float32(3.0))
        for per_edge in (False, True):
            dec.per_edge = per_edge
            _assert_b_equals_plain(dec, syn_T, lch)


@pytest.mark.cuda
def test_group_cascade_on_card(cuda_device, monkeypatch):
    """A small flagship (8 chunks of 512 shots, MS-L-50 on lp118_0) on the
    card with and without the group cascade (QLDPC_GROUP_CASCADE=1 when the
    pipeline is built): counters and iterations equal, and equal to the
    CPU's."""
    from qldpcsim_torch.engine import group_cascade

    monkeypatch.delenv(group_cascade.ENV, raising=False)
    c = get_code("lp118_0")
    cfg = SimConfig(shots=4096, dec_type="MS", dec_iterations=50,
                    dec_schedule="L", batch_size=512, rng_seed=3,
                    device="cuda")

    def counters(r):
        return dict(r.counters, avg_x=r.avg_iterations_x,
                    avg_z=r.avg_iterations_z)

    plain = counters(simulate_p(c.Hx, c.Hz, 0.05, cfg))
    monkeypatch.setenv(group_cascade.ENV, "1")
    pipe = ShotPipeline(c.Hx, c.Hz, cfg)
    monkeypatch.delenv(group_cascade.ENV)
    assert pipe.group_cascade is not None
    before = ms_qc_cuda.LAUNCHES["MS"]
    new = counters(simulate_p(c.Hx, c.Hz, 0.05, cfg, pipeline=pipe))
    assert ms_qc_cuda.LAUNCHES["MS"] > before
    assert pipe.group_cascade.deferred > 0
    on_cpu = counters(simulate_p(c.Hx, c.Hz, 0.05, dataclasses.replace(
        cfg, device="cpu")))
    assert new == plain == on_cpu


@pytest.mark.cuda
def test_group_cascade_bp_osd_on_card(cuda_device, monkeypatch):
    """BP-F-99 + OSD-2 on lp118_0 (config 5's settings, 4 chunks of 1024):
    kernels B and C decode each shot on its own, so the group cascade's
    counters equal the in-chunk cascade's on the card."""
    from qldpcsim_torch.engine import group_cascade

    c = get_code("lp118_0")
    cfg = SimConfig(shots=4096, dec_type="BP", dec_iterations=99,
                    dec_schedule="F", osd_order=2, batch_size=1024,
                    rng_seed=5, device="cuda")
    monkeypatch.delenv(group_cascade.ENV, raising=False)
    plain = simulate_p(c.Hx, c.Hz, 0.05, cfg)
    monkeypatch.setenv(group_cascade.ENV, "1")
    pipe = ShotPipeline(c.Hx, c.Hz, cfg)
    monkeypatch.delenv(group_cascade.ENV)
    new = simulate_p(c.Hx, c.Hz, 0.05, cfg, pipeline=pipe)
    assert pipe.group_cascade.deferred > 0
    assert sum(pipe.osd_shots.values()) > 0
    assert new.counters == plain.counters
    assert new.avg_iterations_x == plain.avg_iterations_x
    assert new.avg_iterations_z == plain.avg_iterations_z



# kernel B's variants under the straggler cascade: (kind, schedule, cap,
# check, state dtype, stacked-update writeback, state in device memory)
CASCADE_VARIANTS = {
    "f32 MS-L-50": ("MS", "L", 50, "iter", torch.float32, False, False),
    "f32 BP-F-99": ("BP", "F", 99, "iter", torch.float32, False, False),
    "bf16 MS-L-50": ("MS", "L", 50, "iter", torch.bfloat16, False, False),
    "bf16 BP-F-99": ("BP", "F", 99, "iter", torch.bfloat16, False, False),
    "vec MS-L-50": ("MS", "L", 50, "iter", torch.float32, True, False),
    "track MS-L-50": ("MS", "L", 50, "layer", torch.float32, False, False),
    "track BP-L-50": ("BP", "L", 50, "layer", torch.float32, False, False),
    "gmem MS-L-50": ("MS", "L", 50, "iter", torch.float32, False, True),
    "gmem BP-F-99": ("BP", "F", 99, "iter", torch.float32, False, True),
}


def _kernel_b_sides(H, device, variant, monkeypatch):
    """The side `make_decoder` builds on the card for one variant of kernel
    B (the state's dtype and the writeback read from the environment, the
    device-memory state forced), and a cascade of the same decoders built
    explicitly, which runs its stages there."""
    from qldpcsim_torch.decoders import TannerGraph, make_decoder
    from qldpcsim_torch.decoders.cascade import make_cascade

    kind, sched, cap, chk, dtype, vec, gmem = CASCADE_VARIANTS[variant]
    st = detect_qc(H)
    cfg = DecoderConfig(dec_type=kind, max_iter=cap, schedule=sched,
                        qc_check_every=chk)

    def factory(graph, c, layers=None):
        d = ms_qc_cuda.make_qc_decoder(st, c, layers=layers, device=device,
                                       dtype=dtype, vec=vec)
        d.state_on_device = d.state_on_device or gmem
        return d

    graph, layers = TannerGraph.build(H), build_layers(H, sched)
    if dtype == torch.bfloat16:
        monkeypatch.setenv("QLDPC_QC_DTYPE", "bf16")
    if vec:
        monkeypatch.setenv("QLDPC_QC_VEC", "1")
    dec = make_decoder(graph, cfg, layers=layers, device=device)
    assert type(dec) is ms_qc_cuda.QCDecoder and dec.max_iter == cap
    assert dec.state_dtype == dtype and dec.vec == vec
    assert dec.track_mis == (chk == "layer")
    dec.state_on_device = dec.state_on_device or gmem
    return dec, make_cascade(factory, graph, cfg, layers)


def _same_result(a, b):
    for name in ("e_hat", "n_iter", "converged", "posterior"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", ["none", "some", "all", "partial"])
@pytest.mark.parametrize("variant", list(CASCADE_VARIANTS))
def test_cascade_full_depth_equals_stages_on_card(cuda_device, variant,
                                                  chunk, monkeypatch):
    """Kernel B's side on the card is its full-depth decoder alone
    (`make_decoder`): one launch whose results equal, bit for bit, those
    of the cascade's stages run on the card; for chunks where no lane, some
    lanes or every lane fails the head, and a partial chunk."""
    H = np.asarray(get_code("lp118_0").Hz) % 2
    dec, casc = _kernel_b_sides(H, cuda_device, variant, monkeypatch)
    p_err = {"none": 0.002, "some": 0.05, "all": 0.3, "partial": 0.05}[chunk]
    syns = [_syndromes(17, H, 4096, p_err, cuda_device)]
    if chunk == "partial":
        syns.append(syns[0][:1000].clone())
        syns[1][700:] = 0
    prior = np.float32(0.05) / np.float32(3.0)
    kind = dec.kind
    for syn in syns:
        before = dict(ms_qc_cuda.LAUNCHES)
        r_full = dec(syn, prior)
        assert ms_qc_cuda.LAUNCHES == dict(before, **{kind: before[kind] + 1})
        r_stages = casc(syn, prior)
        torch.cuda.synchronize()
        _same_result(r_full, r_stages)
        head_fail = int((r_full.n_iter > casc.stages[0][0]).sum())
        n = syn.shape[0]
        assert {"none": head_fail == 0, "some": 0 < head_fail < n,
                "all": head_fail == n,
                "partial": 0 < head_fail < n}[chunk]
    assert casc.stage_lanes[0] == sum(s.shape[0] for s in syns)
    assert casc.syncs > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind,sched,cap,p", [("MS", "L", 50, 0.05),
                                              ("BP", "F", 99, 0.03)])
def test_simulate_p_full_depth_counts_as_stages_on_card(
        cuda_device, monkeypatch, kind, sched, cap, p):
    """`simulate_p` on lp118_0 (the benchmark's two decoders, 2 chunks of
    4096): each side of the pipeline is one kernel-B decoder, launched once
    per chunk, and its counters and iterations equal those of a pipeline
    whose sides run the cascade's stages on the card, on the same seed; both
    name their decoders alike."""
    from qldpcsim_torch import decoders
    from qldpcsim_torch.decoders.cascade import Cascade

    c = get_code("lp118_0")
    cfg = SimConfig(shots=8192, dec_type=kind, dec_iterations=cap,
                    dec_schedule=sched, batch_size=4096, rng_seed=19,
                    device="cuda")
    pipe = ShotPipeline(c.Hx, c.Hz, cfg)
    assert type(pipe.dec_x) is type(pipe.dec_z) is ms_qc_cuda.QCDecoder
    before = ms_qc_cuda.LAUNCHES[kind]
    full = simulate_p(c.Hx, c.Hz, p, cfg, pipeline=pipe)
    assert ms_qc_cuda.LAUNCHES[kind] - before == 2 * 2
    monkeypatch.setattr(decoders, "_one_launch", lambda dec, device: False)
    staged = ShotPipeline(c.Hx, c.Hz, cfg)
    assert isinstance(staged.dec_x, Cascade)
    stages = simulate_p(c.Hx, c.Hz, p, cfg, pipeline=staged)
    assert staged.dec_x.syncs > 0
    assert full.counters == stages.counters
    assert full.avg_iterations_x == stages.avg_iterations_x
    assert full.avg_iterations_z == stages.avg_iterations_z
    assert ([montecarlo._decoder_choice(d) for d in (pipe.dec_x, pipe.dec_z)]
            == [montecarlo._decoder_choice(d)
                for d in (staged.dec_x, staged.dec_z)])


@pytest.mark.cuda
@pytest.mark.parametrize("code,kind,shots,p", [("tanner", "MS", 4096, 0.10),
                                               ("tanner", "BP", 4096, 0.10),
                                               ("lp04_0", "MS", 256, 0.20)],
                         ids=["tanner-MS", "tanner-BP", "lp04_0-MS"])
def test_kernel_d_cascade_full_depth_equals_stages_on_card(cuda_device, code,
                                                           kind, shots, p):
    """The serial schedule on kernel D (30 iterations, one chunk of the
    pipeline's own sampling): each side of the pipeline is one kernel-D
    decoder, one launch, whose results equal, bit for bit, those of the
    guarded cascade's stages run on the card (where the guard fires). The
    Tanner chunk is the benchmark cell's (p 0.10); lp04_0's 256 shots, at
    p 0.20 so that the guard fires there too, are fewer than the card holds
    at once."""
    from qldpcsim_torch.decoders import TannerGraph
    from qldpcsim_torch.decoders.cascade import make_cascade

    c = get_code(code)
    cfg = SimConfig(shots=shots, dec_type=kind, dec_iterations=30,
                    dec_schedule="S", batch_size=shots, rng_seed=23,
                    device="cuda")
    pipe = ShotPipeline(c.Hx, c.Hz, cfg)
    assert pipe.batch == shots
    key = fold_in(prng_key(23, device=pipe.device), 0)
    sy_z, sy_x = pipe._sample_chunk(chunk_keys(key, 0, shots // 64), p)[2:]
    prior = np.float32(p) / np.float32(3.0)
    for dec, syn, H in ((pipe.dec_x, sy_z, pipe.Hz), (pipe.dec_z, sy_x,
                                                       pipe.Hx)):
        assert type(dec) is seq_qc_cuda.SeqQCDecoder and dec.kind == kind
        st, layers = detect_qc(H), build_layers(H, "S")
        casc = make_cascade(
            lambda g, c_, layers=None: seq_qc_cuda.make_seq_qc_decoder(
                st, c_, layers=layers, device=cuda_device, kind=kind),
            TannerGraph.build(H), pipe.dcfg, layers)
        assert casc.highp_guard
        before = dict(seq_qc_cuda.LAUNCHES)
        r_full = dec(syn, prior)
        assert seq_qc_cuda.LAUNCHES == dict(before,
                                            **{kind: before[kind] + 1})
        r_stages = casc(syn, prior)
        torch.cuda.synchronize()
        _same_result(r_full, r_stages)
        assert int((r_full.n_iter > casc.stages[0][0]).sum()) > (
            2 * shots) // 3
        assert casc.guard_fired == 1 and casc.syncs == 1
