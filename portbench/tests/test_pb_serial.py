"""The serial-schedule reference (`reference/decode_serial.py`) against the
program's plain serial decoders on the CPU at small sizes.

Min-sum: bit for bit with kernel D's plain version (`ops/seq_qc_cuda.py`,
row by row) on lp04_0, a circulant-lifted code of lift 7: estimates,
iteration counts, convergence and every posterior value. The program's
row-sequential decoder for codes without a lift (`decoders/sequential.py`)
forms `new - old` with two roundings where kernel D and the reference
fuse them into one, so on Steane its posteriors differ from the
reference's by single ulps while its decisions agree; with the fusion
taken out of the reference the two are equal bit for bit, which shows
that the fusion is the only difference.

BP: numpy's float32 tanh and log round unlike torch's, by an ulp now and
then. A shot whose posterior sits near a sign change can then take another
path. Most shots that neither side brings to convergence oscillate, and an
ulp moves their final estimate; a few that converge latch a row or an
iteration apart. The posteriors of the shots that agree and converged
agree to rounding. The limits sit above what was measured on six cases
of 64 shots at 30 iterations (seeds 3, 4, 8 on Hz and 5, 6, 9 on Hx): 2 to
5 shots decided differently a case, at most 2 of them shots that either
side converged, median posterior gap 2.0e-6 to 4.1e-6.
"""

import numpy as np
import pytest
import torch

from portbench.reference import decode_serial

P = 0.05


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _syndromes(seed, H, shots, rate):
    """Bit flips at `rate`; shot 0 has the zero syndrome."""
    rng = np.random.default_rng(seed)
    e = (rng.random((shots, H.shape[1])) < rate).astype(np.int64)
    e[0] = 0
    return ((e @ H.T.astype(np.int64)) % 2).astype(np.uint8)


def _prior():
    return np.float32(P) / np.float32(3.0)


def _lp04(side):
    from qldpcsim_torch.codes import get_code

    return (np.asarray(getattr(get_code("lp04_0"), side)) % 2).astype(
        np.uint8)


def _kernel_d_plain(H, syn, kind, iters):
    from qldpcsim_torch.decoders import DecoderConfig, build_layers
    from qldpcsim_torch.ops import seq_qc_cuda
    from qldpcsim_torch.ops.qc import detect_qc

    dec = seq_qc_cuda.make_seq_qc_decoder(
        detect_qc(H), DecoderConfig(dec_type=kind, max_iter=iters,
                                    schedule="S"),
        layers=build_layers(H, "S"), kind=kind)
    assert dec.tabs.L == 7
    return dec(torch.as_tensor(syn), _prior())


def _sequential(H, syn, kind, iters):
    from qldpcsim_torch.decoders import DecoderConfig, TannerGraph
    from qldpcsim_torch.decoders.sequential import make_seq_decoder

    dec = make_seq_decoder(TannerGraph.build(H), DecoderConfig(
        dec_type=kind, max_iter=iters, schedule="S"), kind=kind)
    return dec(torch.as_tensor(syn), _prior())


def _equal(out, ref):
    e, it, cv, post = ref
    assert (out.e_hat.numpy() == e).all()
    assert (out.n_iter.numpy() == it).all()
    assert (out.converged.numpy() == cv).all()
    return out.posterior.numpy(), post


@pytest.mark.parametrize("side,rate,seed", [("Hz", 0.05, 1), ("Hx", 0.08, 2),
                                            ("Hz", 0.08, 3)])
def test_min_sum_equals_kernel_d_plain_bit_for_bit(side, rate, seed):
    H = _lp04(side)
    syn = _syndromes(seed, H, 64, rate)
    ref = decode_serial.decode(H, syn, P, "MS", "S", 12)
    prog, post = _equal(_kernel_d_plain(H, syn, "MS", 12), ref)
    assert np.array_equal(prog, post)          # by value: -0.0 == 0.0
    _, it, cv, _ = ref
    assert it[0] == 1 and cv[0]                # the zero syndrome: row 0
    assert (~cv).any() and (it[~cv] == 12).all()
    assert len(np.unique(it[cv])) >= 3


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_min_sum_against_the_sequential_decoder(seed, monkeypatch):
    from qldpcsim_torch.codes import get_code

    H = (np.asarray(get_code("steane").Hz) % 2).astype(np.uint8)
    syn = _syndromes(seed, H, 256, 0.1)
    out = _sequential(H, syn, "MS", 12)
    prog, post = _equal(out, decode_serial.decode(H, syn, P, "MS", "S", 12))
    rel = np.abs(prog - post) / np.maximum(np.abs(post), 1.0)
    assert rel.max() <= 2.0 ** -23             # an ulp at most
    monkeypatch.setattr(decode_serial, "fma32",
                        lambda a, b, c: (a * b) + c)
    unfused = decode_serial.decode(H, syn, P, "MS", "S", 12)
    prog, post = _equal(out, unfused)
    assert np.array_equal(prog, post)
    _, it, cv, _ = unfused
    assert it[0] == 1 and (~cv).any() and (it[~cv] == 12).all()


@pytest.mark.parametrize("side,seed", [("Hz", 3), ("Hz", 4), ("Hx", 5),
                                       ("Hx", 6)])
def test_bp_agrees_with_kernel_d_plain_to_rounding(side, seed):
    H = _lp04(side)
    syn = _syndromes(seed, H, 64, 0.05)
    out = _kernel_d_plain(H, syn, "BP", 30)
    e, it, cv, post = decode_serial.decode(H, syn, P, "BP", "S", 30)
    differ = ((out.e_hat.numpy() != e).any(1) | (out.n_iter.numpy() != it)
              | (out.converged.numpy() != cv))
    assert differ.sum() <= 8
    assert (differ & (cv | out.converged.numpy())).sum() <= 3
    agree = ~differ & cv
    rel = np.abs(out.posterior.numpy()[agree] - post[agree]) / np.maximum(
        np.abs(post[agree]), 1.0)
    assert np.median(rel.mean(axis=1)) < 1e-5
    assert it[0] == 1 and cv[0]


def test_fma32_rounds_once():
    """The fused multiply-add against exact rational arithmetic: random
    sums that cancel, and products that are float32 ties, 1 + 2^-24 =
    (24929 / 2^15) (673 / 2^9), plus or minus 2^-60, which float64 rounds
    back onto the tie (a float64 sum rounded to float32 gets them wrong),
    and sums in float32's subnormal range."""
    from fractions import Fraction

    rng = np.random.default_rng(7)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (-(a.astype(np.float64) * b)).astype(np.float32) * np.float32(
        1 + 2.0 ** -22)
    a[:4] = np.float32(24929 / 2**15) * np.float32([1, 1, -1, -1])
    b[:4] = np.float32(673 / 2**9)
    c[:4] = np.float32(2.0 ** -60) * np.float32([1, -1, 1, -1])
    # sums in float32's subnormal range
    a[4:8] = np.float32([1.5, -1.25, 1.75, -1.125]) * np.float32(2.0 ** -70)
    b[4:8] = np.float32([1.375, 1.625, -1.0625, 1.8125]) * np.float32(
        2.0 ** -70)
    c[4:8] = np.float32([2.0 ** -140, -3 * 2.0 ** -145, 2.0 ** -149,
                         5 * 2.0 ** -147])
    got = decode_serial.fma32(a, b, c)
    assert got[0] == np.nextafter(np.float32(1), np.float32(2))
    assert got[3] == -got[0]
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        # the nearest float32, ties to even, from the exact value
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo,
                 np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda f: (abs(Fraction(float(f)) - exact),
                                         int(np.float32(f).view(np.int32))
                                         & 1))
        assert g == best


def test_schedule_and_kind_are_checked():
    H = _lp04("Hz")
    syn = _syndromes(1, H, 2, 0.05)
    with pytest.raises(ValueError, match="schedule S"):
        decode_serial.decode(H, syn, P, "MS", "L", 5)
    with pytest.raises(ValueError, match="MS or BP"):
        decode_serial.decode(H, syn, P, "BF", "S", 5)
