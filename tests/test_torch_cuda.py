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
from qldpcsim_torch.decoders.osd import OSD, OSDStatic
from qldpcsim_torch.engine.montecarlo import SimConfig, simulate_p
from qldpcsim_torch.ops import (
    _build,
    channel_cuda,
    general_h_cuda,
    gf2_elim_cuda,
    ms_qc_cuda,
    seq_qc_cuda,
)
from qldpcsim_torch.ops.qc import detect_qc
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


def _decoder(H, sched, device, max_iter=50, kind="MS"):
    return ms_qc_cuda.make_qc_decoder(
        detect_qc(H), DecoderConfig(dec_type=kind, max_iter=max_iter,
                                    schedule=sched),
        layers=build_layers(H, sched), device=device)


def _seq_decoder(H, device, max_iter, kind="MS"):
    return seq_qc_cuda.make_seq_qc_decoder(
        detect_qc(H), DecoderConfig(dec_type=kind, max_iter=max_iter,
                                    schedule="S"),
        layers=build_layers(H, "S"), device=device, kind=kind)


def _general_matrix(name):
    """Matrices with no circulant lift: lp118_0's Hz with its columns
    permuted (240 x 544, row weight 8), bicycle's Hz (73 x 146, row weight
    18, one-row layers), and a random 240 x 544 matrix of row weights 3 to
    8."""
    if name == "lp118_perm":
        perm = np.random.default_rng(118).permutation(544)
        H = (np.asarray(get_code("lp118_0").Hz) % 2)[:, perm]
    elif name == "bicycle":
        H = np.asarray(get_code("bicycle").Hz) % 2
    else:
        rng = np.random.default_rng(7)
        H = np.zeros((240, 544), np.int8)
        for i in range(240):
            H[i, rng.choice(544, int(rng.integers(3, 9)), replace=False)] = 1
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


def test_wrappers_reject_malformed_input():
    with pytest.raises(ValueError):
        channel_cuda.sample_tiles_cuda(torch.zeros(4, 3, dtype=torch.int64),
                                       0.05, 544, 64)
    with pytest.raises(ValueError):
        channel_cuda.sample_tiles_cuda(torch.zeros(4, 2, dtype=torch.int32),
                                       0.05, 544, 64)
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
    H = np.asarray(get_code("lp04_0").Hz) % 2
    with pytest.raises(ValueError):
        ms_qc_cuda.ms_qc(_decoder(H, "L", "cpu", max_iter=4),
                         torch.zeros(H.shape[0], 8, device="meta"), 1.0)
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


@pytest.mark.cuda
@pytest.mark.parametrize("code,sched", [
    ("lp118_0", "L"), ("lp118_0", "F"), ("tanner", "L"), ("lp04_0", "F"),
])
def test_ms_qc_kernel_equals_plain(cuda_device, code, sched):
    H = np.asarray(get_code(code).Hz) % 2
    dec = _decoder(H, sched, cuda_device)
    syn_T = _syndromes(7, H, 300, 0.05, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
    before = ms_qc_cuda.LAUNCHES["MS"]
    kp, ki, kc = ms_qc_cuda.ms_qc(dec, syn_T, lch)
    pp, pi, pc = ms_qc_cuda.ms_qc_plain(dec, syn_T, lch)
    assert ms_qc_cuda.LAUNCHES["MS"] == before + 1
    assert kc.any() and ki.max() > 1
    assert torch.equal(kp, pp) and torch.equal(ki, pi) and torch.equal(kc, pc)


@pytest.mark.cuda
@pytest.mark.parametrize("code,sched", [
    ("lp118_0", "F"), ("lp118_0", "L"), ("lp04_0", "F"),
])
def test_bp_qc_kernel_equals_plain(cuda_device, code, sched):
    """Kernel B, kind BP: tanhf, logf and IEEE division, as torch's tanh,
    log and `/` on the card, so bit for bit, posterior included."""
    H = np.asarray(get_code(code).Hz) % 2
    dec = _decoder(H, sched, cuda_device, max_iter=30, kind="BP")
    syn_T = _syndromes(8, H, 300, 0.05, cuda_device).T.contiguous()
    lch = ms_qc_cuda.llr_prior(np.float32(0.03) / np.float32(3.0))
    before = dict(ms_qc_cuda.LAUNCHES)
    kp, ki, kc = ms_qc_cuda.ms_qc(dec, syn_T, lch)
    pp, pi, pc = ms_qc_cuda.ms_qc_plain(dec, syn_T, lch)
    assert ms_qc_cuda.LAUNCHES == dict(before, BP=before["BP"] + 1)
    assert kc.any() and not kc.all()
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    assert torch.equal(kp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("code,B,max_iter,p_err", [
    ("lp04_0", 300, 30, 0.05),     # small shape, full depth
    ("lp118_0", 300, 8, 0.04),     # lift 16
    ("tanner", 4096, 3, 0.047),    # the main path's shape (config 4 chunk)
    ("tanner", 128, 16, 0.047),    # the main path's last-stage window
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
        syn_T[:, 0] = 0.0           # a zero syndrome: one row, n_iter == 1
        lch = ms_qc_cuda.llr_prior(np.float32(0.07) / np.float32(3.0))
        before = dict(seq_qc_cuda.LAUNCHES)
        kp, ki, kc = seq_qc_cuda.seq_qc(dec, syn_T, lch)
        pp, pi, pc = seq_qc_cuda.seq_qc_plain(dec, syn_T, lch)
        assert seq_qc_cuda.LAUNCHES == dict(before, **{kind: before[kind] + 1})
        assert int(ki[0]) == 1 and bool(kc[0]) and not (kp[:, 0] < 0).any()
        assert kc.any() and ki.max() > 1
        assert torch.equal(ki, pi) and torch.equal(kc, pc)
        assert torch.equal(kp < 0, pp < 0)
        assert torch.equal(kp, pp)


@pytest.mark.cuda
@pytest.mark.parametrize("B,max_iter", [(1, 20), (63, 20), (4096, 4)])
@pytest.mark.parametrize("name", ["lp118_perm", "bicycle", "irregular"])
@pytest.mark.parametrize("sched", ["L", "F"])
@pytest.mark.parametrize("kind", ["MS", "BP"])
def test_general_h_kernel_equals_plain(cuda_device, kind, sched, name, B,
                                       max_iter):
    """Kernel E against its plain version: n_iter and converged equal, and
    the posterior equal by value on every element (tolerance 0): under L
    each posterior entry takes one delta per layer, under F both sum a
    variable's deltas in ascending edge order; BP through the CUDA math
    library's tanhf and logf on both sides."""
    H = _general_matrix(name)
    dec = _gh_decoder(H, sched, cuda_device, max_iter, kind)
    syn_T = _syndromes(3, H, B, 0.01 if name == "bicycle" else 0.017,
                       cuda_device).T.contiguous()
    if B > 1:
        syn_T[:, 0] = 0.0           # a zero syndrome: one iteration
    lch = ms_qc_cuda.llr_prior(np.float32(0.05) / np.float32(3.0))
    before = dict(general_h_cuda.LAUNCHES)
    kp, ki, kc = general_h_cuda.general_h(dec, syn_T, lch)
    pp, pi, pc = general_h_cuda.general_h_plain(dec, syn_T, lch)
    assert general_h_cuda.LAUNCHES == dict(before, **{kind: before[kind] + 1})
    if B > 1:
        assert int(ki[0]) == 1 and bool(kc[0]) and not (kp[:, 0] < 0).any()
        assert kc.any() and ki.max() > 1
    assert torch.equal(ki, pi) and torch.equal(kc, pc)
    assert torch.equal(kp < 0, pp < 0)
    assert torch.equal(kp, pp)


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
    the kernel, the wrapper raises and does not fall back to the plain
    version."""
    blocked = tmp_path / "file"
    blocked.write_text("not a directory")
    monkeypatch.setattr(_build, "BUILD_DIR", blocked / "build")
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
