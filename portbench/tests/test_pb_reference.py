"""The plain reference against the program's CPU path at small shot counts:
the key contract and the channel bit for bit, min-sum bit for bit, BP to
rounding, OSD-2 and the classification exactly."""

from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import channel, classify, decode, keys, osd

ROOT = Path(__file__).resolve().parents[2]
DATA = ROOT / "portbench" / "data"
SEED = 2**31 + 12345


@pytest.fixture(scope="module")
def code():
    return (np.load(DATA / "Hx_LP118_0.npy"), np.load(DATA / "Hz_LP118_0.npy"))


def _pipeline(code, kind, schedule, iters, osd_order=-1, batch=128):
    from qldpcsim_torch.engine.montecarlo import ShotPipeline, SimConfig

    cfg = SimConfig(shots=batch, dec_type=kind, dec_iterations=iters,
                    dec_schedule=schedule, osd_order=osd_order,
                    rng_seed=SEED, batch_size=batch, device="cpu")
    return ShotPipeline(code[0], code[1], cfg)


def _chunk(pipe, p, p_index, chunk):
    from qldpcsim_torch.parallel.keys import chunk_keys
    from qldpcsim_torch.utils.threefry import fold_in, prng_key

    key = fold_in(prng_key(SEED), p_index)
    return pipe._sample_chunk(chunk_keys(key, chunk * pipe.tiles_per_chunk,
                                         pipe.tiles_per_chunk), p)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_keys_match_the_program(seed):
    from qldpcsim_torch.utils import threefry as tf

    k = keys.fold_in(keys.prng_key(seed), 9)
    want = tf.fold_in(tf.prng_key(seed), 9)
    assert k.tolist() == want.tolist()
    bits = keys.random_bits(k[None, :], 300)[0]
    assert bits.tolist() == tf.random_bits(want, (300,)).tolist()


@pytest.mark.parametrize("p", [0.01, 0.03, 0.05, 0.1])
def test_channel_and_syndromes_bit_for_bit(code, p):
    pipe = _pipeline(code, "MS", "L", 50)
    ex, ez, sz, sx = _chunk(pipe, p, 3, 5)
    rex, rez = channel.sample(SEED, 3, p, 544, pipe.tile,
                              5 * pipe.tiles_per_chunk, pipe.tiles_per_chunk)
    assert (rex == ex.numpy()).all() and (rez == ez.numpy()).all()
    assert (channel.syndrome(code[1], rex) == sz.numpy()).all()
    assert (channel.syndrome(code[0], rez) == sx.numpy()).all()


@pytest.mark.parametrize("p", [0.01, 0.03, 0.05, 0.1])
def test_prior_matches_the_program(p):
    from qldpcsim_torch.ops.ms_qc_cuda import llr_prior

    q = np.float32(p) / np.float32(3.0)
    assert decode.prior_llr(p) == np.float32(llr_prior(q))


@pytest.mark.parametrize("p", [0.03, 0.05, 0.08])
def test_min_sum_layered_bit_for_bit(code, p):
    pipe = _pipeline(code, "MS", "L", 50)
    _, _, sz, sx = _chunk(pipe, p, 1, 0)
    res = pipe._decode_sides(sz, sx, p)
    for H, syn, r in ((code[1], sz, res[0]), (code[0], sx, res[1])):
        e, it, cv, post = decode.decode(H, syn.numpy(), p, "MS", "L", 50)
        assert (e == r.e_hat.numpy()).all()
        assert (it == r.n_iter.numpy()).all()
        assert (cv == r.converged.numpy()).all()
        assert (post == r.posterior.numpy()).all()


@pytest.mark.parametrize("schedule", ["F", "L"])
def test_bp_to_rounding(code, schedule):
    p = 0.04
    pipe = _pipeline(code, "BP", schedule, 30)
    _, _, sz, _ = _chunk(pipe, p, 2, 1)
    r = pipe.dec_x(sz, np.float32(p) / np.float32(3.0))
    e, it, cv, post = decode.decode(code[1], sz.numpy(), p, "BP", schedule,
                                    30)
    differ = ((e != r.e_hat.numpy()).any(1) | (it != r.n_iter.numpy())
              | (cv != r.converged.numpy()))
    assert differ.mean() <= 0.02
    agree = ~differ & cv
    rel = np.abs(post[agree] - r.posterior.numpy()[agree]) / np.maximum(
        np.abs(post[agree]), 1.0)
    assert np.median(rel.mean(1)) < 2e-4


@pytest.mark.parametrize("order", [0, 1, 2])
def test_osd_equals_the_program(code, order):
    from qldpcsim_torch.decoders.osd import OSD

    p = 0.09
    pipe = _pipeline(code, "BP", "F", 8)
    _, _, sz, _ = _chunk(pipe, p, 4, 2)
    r = pipe.dec_x(sz, np.float32(p) / np.float32(3.0))
    failed = ~r.converged
    assert int(failed.sum()) >= 8
    prog = OSD(code[1], order)(r.e_hat[failed], sz[failed],
                               r.posterior[failed]).numpy()
    ref = osd.osd(code[1], order, r.e_hat[failed].numpy(),
                  sz[failed].numpy().astype(np.uint8),
                  r.posterior[failed].numpy())
    assert (ref == prog).all()
    # every estimate reproduces its syndrome
    s = (ref.astype(np.int64) @ code[1].T.astype(np.int64)) & 1
    assert (s == sz[failed].numpy()).all()


@pytest.mark.parametrize("weight", [0, 1, 4, 20])
def test_classification_equals_the_program(code, weight):
    from qldpcsim_torch.engine.classify import ClassifierStatic, classify_batch

    rng = np.random.default_rng(weight)
    B, n = 200, 544
    err_x = (rng.random((B, n)) < 0.02).astype(np.uint8)
    err_z = (rng.random((B, n)) < 0.02).astype(np.uint8)
    # estimates: the error with `weight` bits flipped, stabilizers added
    ex, ez = err_x.copy(), err_z.copy()
    for e, H in ((ex, code[0]), (ez, code[1])):
        for b in range(B):
            e[b, rng.choice(n, size=weight, replace=False)] ^= 1
            if b % 3 == 0:
                e[b] ^= (H[rng.integers(H.shape[0])] % 2).astype(np.uint8)
    valid = rng.random(B) < 0.9
    st = ClassifierStatic.build(code[0], code[1])
    t = torch.as_tensor
    prog = classify_batch(st, t(err_x), t(err_z), t(ex), t(ez), None, None,
                          valid=t(valid))
    ref = classify.Classifier(code[0], code[1]).counts(err_x, err_z, ex, ez,
                                                       valid)
    assert ref == {k: int(v) for k, v in prog.items()}
