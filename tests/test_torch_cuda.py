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
from qldpcsim_torch.decoders import DecoderConfig, build_layers
from qldpcsim_torch.engine.montecarlo import SimConfig, simulate_p
from qldpcsim_torch.ops import _build, channel_cuda, ms_qc_cuda
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


def _decoder(H, sched, device, max_iter=50):
    return ms_qc_cuda.make_qc_decoder(
        detect_qc(H), DecoderConfig(dec_type="MS", max_iter=max_iter,
                                    schedule=sched),
        layers=build_layers(H, sched), device=device)


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


def test_other_devices_raise():
    keys = torch.zeros(2, 2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        channel_cuda.sample_tiles(keys, 0.05, 175, 64)
    H = np.asarray(get_code("lp04_0").Hz) % 2
    with pytest.raises(ValueError):
        ms_qc_cuda.ms_qc(_decoder(H, "L", "cpu", max_iter=4),
                         torch.zeros(H.shape[0], 8, device="meta"), 1.0)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError):
        _build.nvcc_path()


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
    before = ms_qc_cuda.LAUNCHES
    kp, ki, kc = ms_qc_cuda.ms_qc(dec, syn_T, lch)
    pp, pi, pc = ms_qc_cuda.ms_qc_plain(dec, syn_T, lch)
    assert ms_qc_cuda.LAUNCHES == before + 1
    assert kc.any() and ki.max() > 1
    assert torch.equal(kp, pp) and torch.equal(ki, pi) and torch.equal(kc, pc)


@pytest.mark.cuda
def test_simulate_p_on_card_equals_cpu(cuda_device):
    c = get_code("lp118_0")
    cfg = SimConfig(shots=1000, dec_type="MS", dec_iterations=50,
                    dec_schedule="L", batch_size=512, rng_seed=3,
                    device="cpu")
    on_cpu = simulate_p(c.Hx, c.Hz, 0.05, cfg)
    launches = (channel_cuda.LAUNCHES, ms_qc_cuda.LAUNCHES)
    on_card = simulate_p(c.Hx, c.Hz, 0.05,
                         dataclasses.replace(cfg, device="cuda"))
    assert channel_cuda.LAUNCHES == launches[0] + 2
    assert ms_qc_cuda.LAUNCHES >= launches[1] + 4
    assert on_card.counters == on_cpu.counters
    assert on_card.avg_iterations_x == on_cpu.avg_iterations_x
    assert on_card.avg_iterations_z == on_cpu.avg_iterations_z
