"""The Tanner cell (`tanner_mss30.p10`: the [[1054,140]] Tanner QC code,
min-sum under the serial schedule, 30 iterations, p 0.10) on the CPU, with
kernel D's plain version: a sound run is `correct` with every decode
number exactly 0 and the cascade's high-p guard fired on both sides;
broken decodes and a one-ulp posterior are not; the layered and flooding
references are told from the serial one; the matrices are the
repository's.

Sizes: 128-shot chunks and jobs of one chunk, so that a refinement window
holds 64 shots (the guard sends about 127 failed lanes a side to two
windows). At p 0.10 nearly every shot runs all 30 iterations, and a chunk
takes tens of seconds on the CPU, so one session serves every run here:
its decoders remember what they decoded, and each run's window replays
the same job (key branch 1 of the seed) from that memory, below the
planted faults."""

import json

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.tests.test_pb_harness import PB, ROOT, _decoder_fault

CELL = "tanner_mss30.p10"
SEED = 2**31 + 101
SIZES = {"shots_per_job_per_card": 128, "shots_per_card_chunk": 128}
DECODE_SHOTS = 64


def _remembered(fwd):
    """`fwd` that decodes each batch of syndromes once and hands out copies
    of that result afterwards."""
    from qldpcsim_torch.decoders.common import DecodeResult

    seen = {}

    def forward(syn, p):
        key = (syn.numpy().tobytes(), float(p))
        if key not in seen:
            seen[key] = fwd(syn, p)
        r = seen[key]
        return DecodeResult(e_hat=r.e_hat.clone(), n_iter=r.n_iter.clone(),
                            converged=r.converged.clone(),
                            posterior=r.posterior.clone())
    return forward


def _counters(s):
    return [(d.guard_fired, list(d.stage_lanes), d.syncs, d.windows)
            for d in (s.slot.dec_x, s.slot.dec_z)]


def _window(s):
    """One job's window and its check, as a run's result line."""
    win = s.window(0.01)
    part = {"rank": 0, "world": 1, "seed": s.seed, "setup_parts": s.parts,
            "window": win, "device": "cpu", "check": s.check(1),
            "forbidden": [], "shapes": {"edges_x": 3720, "edges_z": 3720}}
    return win, harness.result(s.cell, [part], 0.0, False)


@pytest.fixture(scope="module")
def session():
    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "WARM_CHUNKS", 1)
    try:
        cell = harness.load_cell(ROOT, CELL)
        cell.traffic = dict(cell.traffic, **SIZES)
        cell.config["check"] = dict(cell.config["check"],
                                    decode_shots_per_job=DECODE_SHOTS)
        s = harness.Session(cell, SEED, device="cpu")
        s.setup()
        for dec in (s.slot.dec_x, s.slot.dec_z):
            dec.forward = _remembered(dec.forward)
        yield s
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def sound(session):
    """The sound run: its result line, the cascades' counters before and
    after its window, the window, and its check tasks."""
    before = _counters(session)
    win, res = _window(session)
    tasks, _ = session.tasks()
    return res, before, _counters(session), win, tasks


def test_sound_run_is_correct_and_exact(sound):
    res, _, _, _, _ = sound
    assert res["correct"], res["check"]
    assert res["check"]["decode_bad_share"]["value"] == 0.0
    assert res["check"]["posterior_gap"]["value"] == 0.0
    assert all(v["limit"] == 0 for v in res["check"].values())
    assert res["metrics"] == {}          # no CPU number under a metric's name


def test_the_high_p_guard_fires_on_both_sides(sound):
    """The one chunk of the window: the head over its 128 shots, one host
    sync a side, then the failed lanes straight at full depth (the middle
    stage skipped) in 64-shot windows."""
    _, before, after, win, _ = sound
    assert win["host_syncs"] == 2
    for (g0, lanes0, syncs0, w0), (g1, lanes1, syncs1, w1) in zip(before,
                                                                 after):
        head, mid, tail = (b - a for a, b in zip(lanes0, lanes1))
        assert g1 - g0 == 1 and syncs1 - syncs0 == 1
        assert head == 128 and mid == 0 and tail > (2 * 128) // 3
        assert w1 - w0 == -(-tail // 64) == 2


def _one_ulp(s):
    """One posterior entry of every shot moved by one ulp (the entry of
    variable 0, away from zero)."""
    from qldpcsim_torch.decoders.common import DecodeResult

    for dec in (s.slot.dec_x, s.slot.dec_z):
        fwd = dec.forward

        def broken(syn, p, fwd=fwd):
            r = fwd(syn, p)
            post = r.posterior.clone()
            v = post[:, 0].numpy()
            post[:, 0] = torch.from_numpy(np.nextafter(
                v, np.where(v < 0, -np.inf, np.inf).astype(np.float32)))
            return DecodeResult(e_hat=r.e_hat, n_iter=r.n_iter,
                                converged=r.converged, posterior=post)

        dec.forward = broken


FAULTS = {"state unchanged": (_decoder_fault("unchanged"), "decode_bad_share"),
          "answer altered": (_decoder_fault("altered"), "decode_bad_share"),
          "posterior one ulp": (_one_ulp, "posterior_gap")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_decode_is_not_correct(session, sound, fault):
    break_it, number = FAULTS[fault]
    saved = [d.forward for d in (session.slot.dec_x, session.slot.dec_z)]
    break_it(session)
    try:
        _, res = _window(session)
    finally:
        session.slot.dec_x.forward, session.slot.dec_z.forward = saved
    assert not res["correct"]
    assert res["check"][number]["value"] > res["check"][number]["limit"]


@pytest.mark.parametrize("schedule", ["L", "F"])
def test_another_schedule_reference_is_told_apart(sound, schedule):
    """The sound run's kept chunk held to the layered or flooding reference
    (`decode`) in place of the serial one: its decodes differ."""
    tasks = sound[4]
    assert tasks and all(t["reference"] == "decode_serial" for t in tasks)
    for t in tasks:
        r = check.check_chunk(dict(t, reference="decode", decoder=dict(
            t["decoder"], schedule=schedule)))
        assert r["pairs"] == 2 * DECODE_SHOTS and r["decode_bad"] > 0


@pytest.mark.parametrize("side", ["Hx", "Hz"])
def test_matrices_are_the_repository_s(side):
    conf = json.loads((PB / "configs" / "tanner_mss30.json").read_text())
    copy = np.load(ROOT / conf["code"][side])
    orig = np.load(ROOT / "data" / f"{side}_T.npy")
    assert copy.dtype == np.uint8 and copy.shape == orig.shape == (465, 1054)
    assert np.array_equal(copy, orig)
    code = conf["code"]
    assert int(copy.sum()) == code["edges_per_side"]
    assert copy.shape == (code["checks_per_side"], code["qubits"])
