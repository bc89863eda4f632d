"""The port's parity harness (`qldpcsim_torch/utils/parity.py`,
`parity_torch.py`) against the JAX package's `benchmarks/parity.py` on the
CPU: the same rows, the oracle side's qBLER equal row by row (the same numpy
channel and the same native core), the per-shot BF and NG decoders equal
`tests/oracle.py`'s, the z-test's fields, and the ways it refuses or fails:
a corrupted engine side, `QLDPC_NATIVE=0`, `--oracle reference`, a CUDA
device without a card. The engine side against the JAX package's is in
tests/test_torch_parity_engine.py."""

import dataclasses
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import oracle
from qldpcsim_tpu.codes import get_code as ref_get_code

from qldpcsim_torch.codes import get_code
from qldpcsim_torch.utils import parity

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_parity():
    """The JAX package's `benchmarks/parity.py` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_parity", ROOT / "benchmarks" / "parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_rows_are_the_jax_harness_rows(monkeypatch, jax_parity):
    """Every row's code, p, decoder, schedule, OSD order, BF residual and
    both shot counts, in order, as the JAX harness's native mode runs them
    at scale 1."""
    calls = []

    def record(name, code, p, n_new, n_ref, dec_type, iters, schedule,
               osd_order=-1, seed=0, bf_residual="mod2",
               oracle_mode="native"):
        calls.append(parity.Row(name, code, p, n_new, n_ref, dec_type, iters,
                                schedule, osd_order, bf_residual))
        return {"pass": True, "bound": 0.0}

    monkeypatch.setattr(jax_parity, "run_one", record)
    assert jax_parity.main([]) == 0
    assert calls == list(parity.ROWS)
    assert parity.Z == jax_parity.Z


def _oracle_shots(row):
    # NG at p 0.01 fails rarely: more shots, so that the rows differ from 0
    return 2048 if row.dec_type == "NG" else 256


@pytest.mark.parametrize("row", parity.ROWS, ids=lambda r: r.name)
def test_oracle_equals_the_jax_harness(jax_parity, row):
    """The channel, one side's oracle estimates and the oracle's qBLER
    equal the JAX harness's, tolerance 0, at the same seed."""
    shots = _oracle_shots(row)
    code, ref_code = get_code(row.code), ref_get_code(row.code)
    ch = parity.sample_channel(code, row.p, shots, 0)
    ref_ch = jax_parity._sample_channel(ref_code, row.p, shots, 0)
    for a, b in zip(ch, ref_ch):
        np.testing.assert_array_equal(a, b)
    Hz, sy_z = ch[1], ch[4]
    layers = ([np.arange(Hz.shape[0])] if row.schedule == "F" else
              parity.layerize(Hz, serial=row.schedule == "S"))
    args = (Hz, sy_z, row.p, row.dec_type, row.iters, layers, row.osd_order,
            row.bf_residual)
    ex = parity._decode_side_batch(*args)
    np.testing.assert_array_equal(ex, jax_parity._decode_side_batch(*args))
    q = parity.oracle_qbler(code, row.p, shots, row.dec_type, row.iters,
                            row.schedule, row.osd_order, 0, row.bf_residual)
    q_ref = jax_parity.oracle_qbler(ref_code, row.p, shots, row.dec_type,
                                    row.iters, row.schedule, row.osd_order,
                                    0, row.bf_residual)
    assert q == q_ref
    assert 0.0 < q < 1.0


@pytest.mark.parametrize("p", [0.02, 0.06])
def test_per_shot_bf_and_ng_equal_tests_oracle(p):
    """The port's per-shot BF (both residuals) and NG against
    tests/oracle.py's on the bicycle code: errors drawn at p, and syndromes
    drawn at random (most of them no error's)."""
    H = np.asarray(get_code("bicycle").Hz) % 2
    rng = np.random.default_rng(int(p * 100))
    errs = (rng.random((40, H.shape[1])) < p).astype(np.int64)
    syns = np.concatenate([(errs @ H.T) % 2,
                           (rng.random((20, H.shape[0])) < 0.1)])
    for syn in syns.astype(np.int64):
        for res in ("mod2", "bool"):
            e, it, conv = parity.bf_decode(H, syn, residual=res)
            e_ref, it_ref, conv_ref = oracle.bf_decode(H, syn, residual=res)
            np.testing.assert_array_equal(e, e_ref)
            assert (it, conv) == (it_ref, conv_ref)
        e, steps = parity.ng_decode(H, syn)
        e_ref, steps_ref = oracle.ng_decode(H, syn)
        np.testing.assert_array_equal(e, e_ref)
        assert steps == steps_ref


def test_the_z_test_and_fields_are_the_jax_harness(monkeypatch, jax_parity):
    """For the same two estimates both harnesses give the same bound,
    verdict and row fields; the port adds where and how long each side
    ran."""
    est = {"q_new": 0.30, "q_ref": 0.28}
    for mod in (parity, jax_parity):
        monkeypatch.setattr(mod, "engine_qbler",
                            lambda *a, **k: (est["q_new"], 1234.5))
        monkeypatch.setattr(mod, "oracle_qbler",
                            lambda *a, **k: est["q_ref"])
    for q_ref in (0.28, 0.20):
        est["q_ref"] = q_ref
        args = ("3_bicycle_bf", "bicycle", 0.02, 100000, 20000, "BF", 50, "F")
        got = parity.run_one(*args, device="cpu")
        want = jax_parity.run_one(*args)
        assert {k: got[k] for k in want if k != "oracle_shots_per_s"} == {
            k: want[k] for k in want if k != "oracle_shots_per_s"}
        assert set(got) - set(want) == {"device", "seconds_engine",
                                        "seconds_oracle", "card"}
        assert got["device"] == "cpu" and got["card"] is None
    assert want["pass"] is False and 0.0 < want["bound"] <= 0.02


FIELDS = {"config": str, "code": str, "decoder": str, "schedule": str,
          "osd": int, "p": float, "oracle": str, "device": str,
          "qBLER_new": float, "shots_new": int, "qBLER_ref": float,
          "shots_ref": int, "bound": float, "pass": bool,
          # the warm rate leaves the first chunk out: None for one chunk
          "engine_shots_per_s": type(None), "oracle_shots_per_s": float,
          "seconds_engine": float, "seconds_oracle": float,
          "card": type(None)}


def test_command_line_prints_one_line_of_every_field():
    """`parity_torch.py --device cpu --only 2_steane --engine-shots 512
    --scale 0.02` in its own process: one JSON line, every field of its
    type (512 shots are one chunk: no warm rate), the summary on stderr,
    exit 0."""
    out = subprocess.run(
        [sys.executable, "parity_torch.py", "--device", "cpu", "--only",
         "2_steane", "--engine-shots", "512", "--scale", "0.02"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == set(FIELDS)
    for k, t in FIELDS.items():
        assert type(line[k]) is t, (k, line[k])
    assert (line["config"], line["shots_new"], line["shots_ref"],
            line["device"], line["oracle"]) == (
        "2_steane_nms_layered", 512, 400, "cpu", "native")
    assert line["pass"] is True
    assert "# parity: 1/1 within 4.0-sigma; max bound" in out.stderr


def test_a_corrupted_engine_side_fails(monkeypatch, capsys, tmp_path):
    """The engine's X estimates zeroed: the row is outside its bound,
    `pass` is false and main returns 1, after writing the line."""
    real = parity.ShotPipeline

    def corrupted(*a, **k):
        pipe = real(*a, **k)
        forward = pipe.dec_x.forward

        def zeroed(*fa, **fk):
            r = forward(*fa, **fk)
            return dataclasses.replace(r, e_hat=torch.zeros_like(r.e_hat))

        pipe.dec_x.forward = zeroed
        return pipe

    monkeypatch.setattr(parity, "ShotPipeline", corrupted)
    out = tmp_path / "rows.jsonl"
    rc = parity.main(["--device", "cpu", "--only", "2_steane",
                      "--engine-shots", "512", "--scale", "0.02",
                      "--out", str(out)])
    line = json.loads(capsys.readouterr().out)
    assert rc == 1 and line["pass"] is False
    assert line["qBLER_new"] - line["qBLER_ref"] > line["bound"]
    assert json.loads(out.read_text()) == line


def test_native_core_off_raises(monkeypatch):
    """Under QLDPC_NATIVE=0 an MS or BP row raises before it runs, naming
    why; BF and NG need no native core."""
    monkeypatch.setenv("QLDPC_NATIVE", "0")
    code = get_code("steane")
    with pytest.raises(RuntimeError, match="QLDPC_NATIVE=0"):
        parity.oracle_qbler(code, 0.05, 64, "MS", 50, "L", -1, 0)
    with pytest.raises(RuntimeError, match="native GF"):
        parity.run_one("1_shor_bp_p01", "shor", 0.01, 64, 64, "BP", 99, "F",
                       device="cpu")
    assert 0.0 <= parity.oracle_qbler(get_code("bicycle"), 0.02, 64, "BF",
                                      50, "F", -1, 0) <= 1.0


def test_reference_oracle_raises():
    with pytest.raises(ValueError, match="not part of this repository"):
        parity.main(["--oracle", "reference", "--device", "cpu"])
    with pytest.raises(ValueError, match="literal reference simulator"):
        parity.oracle_qbler(get_code("steane"), 0.05, 64, "MS", 50, "L", -1,
                            0, oracle_mode="reference")


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parity.main(["--only", "2_steane"])
    with pytest.raises(RuntimeError):
        parity.engine_qbler(get_code("steane"), 0.05, 64, "MS", 50, "L", -1,
                            0)


def test_only_matching_nothing_raises():
    with pytest.raises(ValueError, match="no row starts with"):
        parity.main(["--device", "cpu", "--only", "9_none"])
