"""The port's command line (`python -m qldpcsim_torch`, `cli.main`) against
the JAX package's on the same arguments with `--device cpu`: the same flags
and defaults (`--device` and `--execMode` differ in their choices), the same
table and `--out` lines for MS, BF and NG on Shor and Steane (counters
equal; BP's qBLER within 4 sigma), a `--mesh-p` sweep, exit code 2 on bad
input, the card by default."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from qldpcsim_tpu import cli as ref_cli

from qldpcsim_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING_KEYS = {"wall_time_s", "shots_per_s", "warm_time_s",
               "shots_per_s_warm"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _table(stdout):
    lines = stdout.splitlines()
    i = next(k for k, ln in enumerate(lines) if "SIMULATION RESULTS" in ln)
    return lines[i:]


def _run_both(args, tmp_path, capsys):
    out = {}
    for name, main in (("ref", ref_cli.main), ("port", cli.main)):
        path = tmp_path / f"{name}.jsonl"
        rc = main([*args, "--device", "cpu", "--quiet", "--out", str(path)])
        assert rc == 0
        rows = [json.loads(ln) for ln in path.read_text().splitlines()]
        out[name] = (_table(capsys.readouterr().out), rows)
    return out["ref"], out["port"]


@pytest.mark.parametrize("code,dec_args", [
    ("shor", ["--decType", "MS", "--decIterations", "8"]),
    ("steane", ["--decType", "MS", "--decIterations", "20",
                "--decSchedule", "L"]),
    ("steane", ["--decType", "MS", "--decIterations", "8", "--OSDorder", "2",
                "--validateEncoding"]),
    ("shor", ["--decType", "BF"]),
    ("steane", ["--decType", "BF", "--bfResidual", "bool"]),
    ("steane", ["--decType", "NG"]),
])
def test_table_and_out_lines_equal_the_reference_cli(code, dec_args, tmp_path,
                                                     capsys):
    args = ["--code", code, "--p", "0.02", "0.08", "--shots", "300",
            "--batch", "128", "--rngSeed", "3", *dec_args]
    (ref_table, ref_rows), (table, rows) = _run_both(args, tmp_path, capsys)
    assert table == ref_table and len(table) == 6
    assert len(rows) == len(ref_rows) == 2
    for a, b in zip(ref_rows, rows):
        assert set(a) == set(b) and TIMING_KEYS <= set(b)
        for k in set(a) - TIMING_KEYS:
            assert a[k] == b[k], k


def test_matrix_files_and_bp_within_4_sigma(tmp_path, capsys):
    shots = 2000
    args = ["--Hx", os.path.join(REPO, "data", "Hx_steane.npy"),
            "--Hz", os.path.join(REPO, "data", "Hz_steane.npy"),
            "--p", "0.05", "--shots", str(shots), "--decType", "BP",
            "--decIterations", "20", "--rngSeed", "1"]
    (_, (a,)), (_, (b,)) = _run_both(args, tmp_path, capsys)
    pool = (a["qBLER"] + b["qBLER"]) / 2
    sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
    assert abs(a["qBLER"] - b["qBLER"]) <= 4 * sigma
    assert 0.0 < b["qBLER"] < 1.0


def test_arguments_echo_and_progress_lines(capsys):
    rc = cli.main(["--code", "shor", "--p", "0.05", "--shots", "128",
                   "--batch", "64", "--decType", "BF", "--device", "cpu",
                   "--rngSeed", "0"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "   Command line arguments:" in out and "Namespace(" in out
    assert "decoded 128/128 shots" in out
    assert "SIMULATION RESULTS" in out


def test_flags_are_the_reference_flags_but_for_the_multi_device_ones():
    """Since the multi-device flags came over, the port's flags are the
    reference's, with the same defaults but for `--device` (cuda or cpu);
    `--execMode` takes the one sharded mode (auto or perdevice)."""
    def flags(parser):
        return {s for a in parser._actions for s in a.option_strings}

    ours, theirs = flags(cli.build_parser()), flags(ref_cli.build_parser())
    assert ours == theirs
    assert {"--mesh", "--mesh-p", "--execMode"} <= ours
    choices = {a.dest: a.choices for a in cli.build_parser()._actions}
    assert tuple(choices["execMode"]) == ("auto", "perdevice")
    args = cli.build_parser().parse_args(["--code", "shor", "--p", "0.1"])
    assert args.device == "cuda"
    ref_args = ref_cli.build_parser().parse_args(["--code", "shor", "--p",
                                                  "0.1"])
    for name in vars(args):
        if name != "device":
            assert getattr(args, name) == getattr(ref_args, name), name


@pytest.mark.parametrize("argv", [
    ["--p", "0.1"],                                   # no code
    ["--code", "shor", "--p", "1.5"],                 # p outside [0, 1]
    ["--Hx", "data/Hx_shor.npy", "--p", "0.1"],       # Hz missing
])
def test_bad_input_returns_2(argv, capsys):
    assert cli.main(argv) == 2
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--code", "shor", "--p", "0.1", "--decType", "XX"],
    ["--code", "shor", "--p", "0.1", "--device", "auto"],
    ["--code", "shor", "--p", "0.1", "--execMode", "shardmap"],
    ["--code", "shor"],
])
def test_unknown_choice_exits_2(argv):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 2


def test_mesh_p_sweep_equals_the_serial_runs(tmp_path, capsys):
    """`--mesh-p 2` on a 2-slot CPU mesh (the JAX package's own CLI case):
    the --out rows equal the serial runs' counters, per p."""
    from qldpcsim_tpu.codes import get_code as ref_get_code
    from qldpcsim_tpu.engine.montecarlo import SimConfig as RefSimConfig
    from qldpcsim_tpu.engine.montecarlo import simulate_p as ref_simulate_p

    code = ref_get_code("steane")
    out = tmp_path / "res.jsonl"
    rc = cli.main(["--Hx", os.path.join(REPO, "data", "Hx_steane.npy"),
                   "--Hz", os.path.join(REPO, "data", "Hz_steane.npy"),
                   "--p", "0.01", "0.03", "--shots", "512", "--decType",
                   "MS", "--decIterations", "10", "--rngSeed", "5",
                   "--batch", "512", "--mesh-p", "2", "--device", "cpu",
                   "--quiet", "--out", str(out)])
    assert rc == 0
    assert "SIMULATION RESULTS" in capsys.readouterr().out
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["p"] for r in rows] == [0.01, 0.03]
    for i, row in enumerate(rows):
        ref = ref_simulate_p(code.Hx, code.Hz, row["p"], RefSimConfig(
            shots=512, dec_iterations=10, rng_seed=5, batch_size=512,
            device="cpu"), p_index=i)
        for k, v in ref.counters.items():
            assert row[k] == v, (row["p"], k)


def test_two_ranks_from_the_launcher_environment(tmp_path):
    """Two processes of `python -m qldpcsim_torch --mesh` with the
    environment torchrun sets: rank 0 alone prints the table and writes
    --out, whose counters equal a single-process run's; each rank writes its
    kernel launches (none on the CPU) where QLDPC_LAUNCH_COUNTS says."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    out = tmp_path / "res.jsonl"
    args = [sys.executable, "-m", "qldpcsim_torch", "--code", "steane",
            "--p", "0.03", "--shots", "700", "--batch", "256",
            "--decIterations", "10", "--rngSeed", "3", "--device", "cpu",
            "--mesh", "--quiet", "--out", str(out)]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE="2",
                   QLDPC_LAUNCH_COUNTS=str(tmp_path / "launches"))
        procs.append(subprocess.Popen(args, cwd=REPO, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:]
                                                     for o in outs]
    assert "SIMULATION RESULTS" in outs[0][0] and outs[1][0] == ""
    (row,) = [json.loads(ln) for ln in out.read_text().splitlines()]
    from qldpcsim_torch.codes import get_code
    from qldpcsim_torch.engine.montecarlo import SimConfig, simulate_p

    code = get_code("steane")
    ref = simulate_p(code.Hx, code.Hz, 0.03, SimConfig(
        shots=700, batch_size=256, dec_iterations=10, rng_seed=3,
        device="cpu"))
    assert {k: row[k] for k in ref.counters} == ref.counters
    for rank in range(2):
        counts = json.loads((tmp_path / f"launches.{rank}").read_text())
        assert counts["channel"] == counts["ms_qc MS"] == 0
        assert len(counts) == 11


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--code", "shor", "--p", "0.1", "--shots", "64",
                  "--quiet"])


def test_module_entry_point_and_profile(tmp_path):
    out = tmp_path / "res.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "qldpcsim_torch", "--code", "shor", "--p",
         "0.02", "--shots", "200", "--decType", "MS", "--decIterations", "8",
         "--quiet", "--rngSeed", "3", "--device", "cpu", "--out", str(out),
         "--profile", str(tmp_path / "trace")],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "SIMULATION RESULTS" in r.stdout
    row = json.loads(out.read_text().splitlines()[0])
    assert row["shots"] == 200 and 0.0 <= row["qBLER"] <= 1.0
    trace = tmp_path / "trace" / "p_sweep.trace.json"
    assert trace.stat().st_size > 0
    assert "p_sweep" in trace.read_text()
