"""The port's benchmark (`bench_torch.py`, `qldpcsim_torch/utils/bench.py`)
on the CPU: its counters and iteration sums equal the port's own entry
points at the same seed (`simulate_p`, `simulate`), configs 1-3 and Steane
give the rows of the JAX package's `benchmarks/run_configs.run_config`
(equal for BF, NG and MS, qBLER within 4 sigma for BP), every field is
present and of its type, a corrupted counter makes the line incorrect and
the exit code 1, the multi-card configuration runs as two CPU ranks over
gloo with one process's counters, and the card is the default device."""

import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from qldpcsim_torch.codes import get_code
from qldpcsim_torch.engine.montecarlo import (
    ShotPipeline,
    SimConfig,
    simulate,
    simulate_p,
)
from qldpcsim_torch.utils import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "bench_torch.py")
EVENT_KEYS = ("decSuccessExact", "decSuccessDegen", "DecFailures_X",
              "DecFailures_Z", "successStabilizer", "logicalErrors_X",
              "logicalErrors_Z")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one torch thread
    in each keeps them from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(capsys, argv, rc=0):
    assert bench.main(["--device", "cpu", *argv], script=SCRIPT) == rc
    return [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]


def _case(config):
    (case,) = [c for c in bench.CASES if c.config == config]
    return case


def _port_counters(r):
    return dict(r.counters,
                nIterAccX=int(round(r.avg_iterations_x * r.shots)),
                nIterAccZ=int(round(r.avg_iterations_z * r.shots)))


def _line_counters(line):
    return {k: line[k] for k in (*EVENT_KEYS, "nIterAccX", "nIterAccZ")}


@pytest.mark.parametrize("config,shots", [
    ("flagship", 2048), ("config5_B", 1024), ("msf50_F", 256),
    ("nonqc", 256)])
def test_counters_equal_simulate_p(capsys, config, shots):
    """One line per p whose counters and iteration sums are those of
    `simulate_p` on the configuration's code and decoder at seed 0, with
    the check against the plain versions correct."""
    case = _case(config)
    (line,) = _lines(capsys, ["--config", config, "--shots", str(shots)])
    Hx, Hz = bench.matrices(case)
    cfg = SimConfig(shots=shots, dec_type=case.dec_type,
                    dec_iterations=case.iters, dec_schedule=case.schedule,
                    osd_order=case.osd, rng_seed=0, device="cpu")
    with bench.environ(case.env):
        pipe = ShotPipeline(Hx, Hz, cfg)
    r = simulate_p(Hx, Hz, case.ps[0], cfg, pipeline=pipe)
    assert _line_counters(line) == _port_counters(r)
    assert line["qBLER"] == r.qbler and line["correct"] is True
    assert line["check"]["shots"] == min(
        shots, bench.CHECK_CHUNKS * line["batch"])
    assert line["check"]["rule"] == (
        "qBLER within 4 sigma, decodes shot by shot"
        if case.dec_type == "BP" else "equal")
    if case.dec_type == "BP":
        assert line["check"]["differ"] == {"x": 0, "z": 0}
    assert line["timed_check"] == {
        "invariants_broken": [], "qBLER_diff": 0.0,
        "four_sigma": line["timed_check"]["four_sigma"], "correct": True}


def test_kernel_choice_follows_the_configuration(capsys, monkeypatch):
    """msf50_B builds kernel B's decoder even with QLDPC_QC_STACKED=1 in
    the environment, msf50_F kernel F's without it; the environment is
    left as it was."""
    monkeypatch.setenv(bench.STACKED, "1")
    b, f = _lines(capsys, ["--config", "msf50_B", "--config", "msf50_F",
                           "--shots", "128"])
    assert b["decoders"] == ["QCDecoder", "QCDecoder"]
    assert f["decoders"] == ["QCDecoder:stacked", "QCDecoder:stacked"]
    # kernel F's sums associate otherwise (n_iter moved on 1 of 4096 shots
    # on one H100); at this seed and size nothing moves
    assert _line_counters(b) == _line_counters(f)
    assert os.environ[bench.STACKED] == "1"


def test_config4_equals_simulate_on_the_tanner_files(capsys):
    """config4 runs its p-points on one pipeline, point i on key branch i,
    as `simulate` does on the Tanner code's .npy files (here at p 0.01 and
    0.02: the plain serial decoder takes ~0.25 s a shot at p 0.1)."""
    b = bench.Bench(_case("config4"), (0.01, 0.02), (32, 32), 0, "cpu", 1,
                    None)
    lines = [b.point(0), b.point(1)]
    res = simulate(os.path.join(REPO, "data", "Hx_T.npy"),
                   os.path.join(REPO, "data", "Hz_T.npy"), [0.01, 0.02],
                   shots=32, decType="MS", decIterations=30,
                   decSchedule="S", rngSeed=0, device="cpu")
    capsys.readouterr()
    assert [ln["p"] for ln in lines] == [0.01, 0.02]
    for line, r in zip(lines, res):
        assert _line_counters(line) == _port_counters(r)
        assert line["correct"] is True and line["check"]["shots"] == 32


def _run_configs():
    """The JAX package's `benchmarks/run_configs.py` as a module."""
    spec = importlib.util.spec_from_file_location(
        "run_configs", os.path.join(REPO, "benchmarks", "run_configs.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def configs_1_3_lines():
    """configs_1_3 at 200 shots per p, and Steane at 500 (`bench.main`)."""
    import contextlib
    import io

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        assert bench.main(["--device", "cpu", "--config", "configs_1_3",
                           "--shots", "200"], script=SCRIPT) == 0
        assert bench.main(["--device", "cpu", "--config", "steane_auto",
                           "--config", "steane_gh", "--shots", "500"],
                          script=SCRIPT) == 0
    return [json.loads(ln) for ln in text.getvalue().splitlines()]


@pytest.mark.parametrize("case_name", [
    "1_shor_bp_flood", "2_steane_nms_layered", "3_bicycle_bf",
    "3_bicycle_ng", "steane_auto"])
def test_rows_of_run_configs(capsys, configs_1_3_lines, case_name):
    """Each row against the JAX `run_config` at the same seed and shots:
    failures, logical errors, qBLER and average iterations equal for MS, BF
    and NG; qBLER within 4 sigma for BP. Every row's counters and iteration
    sums also equal the port's `simulate_p`, point i on key branch i."""
    case = next(c for c in bench.CASES if c.case == case_name)
    lines = [ln for ln in configs_1_3_lines if ln["case"] == case_name]
    shots = lines[0]["shots"]
    Hx, Hz = bench.matrices(case)
    cfg = SimConfig(shots=shots, dec_type=case.dec_type,
                    dec_iterations=case.iters, dec_schedule=case.schedule,
                    impl=case.impl, rng_seed=0, device="cpu")
    pipe = ShotPipeline(Hx, Hz, cfg)
    for i, line in enumerate(lines):
        r = simulate_p(Hx, Hz, line["p"], cfg, pipeline=pipe, p_index=i)
        assert _line_counters(line) == _port_counters(r)
    rows = _run_configs().run_config(case.case, case.code, list(case.ps),
                                     shots, case.dec_type, case.iters,
                                     case.schedule, osd_order=case.osd)
    capsys.readouterr()
    assert [ln["p"] for ln in lines] == [row["p"] for row in rows]
    for line, row in zip(lines, rows):
        assert line["correct"] is True
        if case.dec_type == "BP":
            a, b = line["qBLER"], row["qBLER"]
            pool = (a + b) / 2
            sigma = math.sqrt(max(pool * (1 - pool), 1e-12) * 2 / shots)
            assert abs(a - b) <= 4 * sigma
            continue
        for k in ("DecFailures_X", "DecFailures_Z", "logicalErrors_X",
                  "logicalErrors_Z", "qBLER", "qBLER_honest"):
            assert line[k] == row[k], k
        assert round(line["avg_iters_X"], 3) == row["avg_iters_X"]
        assert round(line["avg_iters_Z"], 3) == row["avg_iters_Z"]


def test_impl_gh_takes_kernel_e_with_the_same_decisions(configs_1_3_lines):
    """steane_gh routes Steane's min-sum to the general-H decoder (kernel
    E's plain version here), the auto route to the incidence decoder; the
    event counters agree."""
    auto, gh = [ln for ln in configs_1_3_lines
                if ln["config"] in ("steane_auto", "steane_gh")]
    assert auto["decoders"][0] != gh["decoders"][0]
    assert gh["decoders"][0] == "GHDecoder"
    assert {k: auto[k] for k in EVENT_KEYS} == {k: gh[k] for k in EVENT_KEYS}


_NUM = (int, float)
_OPT = (int, float, type(None))   # None for a one-chunk run
_FIELDS = {
    "config": str, "case": str, "code": str, "permuted": bool,
    "decoder": str, "schedule": str, "iterations": int, "osd": int,
    "impl": str, "env": dict, "decoders": list, "p": float, "shots": int,
    "seed": int, "device": str, "chips": int, "batch": int, "chunks": int,
    "shots_per_s_warm": _OPT, "warm_shots": int, "warm_time_s": _OPT,
    "wall_time_s": _NUM, "shots_per_s": _NUM, **{k: int for k in EVENT_KEYS},
    "nIterAccX": int, "nIterAccZ": int, "qBLER": _NUM, "qBLER_honest": _NUM,
    "avg_iters_X": _NUM, "avg_iters_Z": _NUM, "correct": bool,
    "check": dict, "timed_check": dict, "layer_chunks": int,
    "launches_per_chunk": dict,
    "host_syncs_per_chunk": dict, "required_ops_per_shot": _NUM,
    "host_cpu": str, "torch": str,
    # device numbers: None on the CPU
    "layers_ms_per_chunk": type(None), "idle_share": type(None),
    "trace_kernels": type(None), "trace_ms_per_chunk": type(None),
    "busy_ms_per_chunk": type(None), "warm_ms_per_chunk": _OPT, "peak_mem_bytes": type(None),
    "decode_bound_share": type(None), "card": type(None),
}


def test_every_field_is_present_and_of_its_type(capsys):
    """A CPU line: every field, of its type; the device numbers None; the
    host syncs of the cascade (4 stages reached per chunk at
    most, 2 sides) counted."""
    (line,) = _lines(capsys, ["--config", "flagship", "--shots", "512"])
    assert set(line) == set(_FIELDS)
    for k, t in _FIELDS.items():
        assert isinstance(line[k], t), (k, line[k])
    assert line["launches_per_chunk"] == {}  # no kernel runs on the CPU
    syncs = line["host_syncs_per_chunk"]
    assert set(syncs) == {"cascade", "osd"} and syncs["osd"] == 0
    assert 2 <= syncs["cascade"] <= 4
    assert set(line["check"]) == {"shots", "run", "plain", "rule", "correct"}
    assert set(line["timed_check"]) == {"invariants_broken", "qBLER_diff",
                                        "four_sigma", "correct"}


def test_one_chunk_and_the_trace_pass_on_the_cpu(capsys, tmp_path):
    """A one-chunk run has no warm window; `--profile DIR` runs the trace
    pass and keeps its trace (no device: no kernels, no idle share)."""
    (line,) = _lines(capsys, ["--config", "steane_auto", "--shots", "64",
                              "--profile", str(tmp_path)])
    assert line["chunks"] == 1 and line["shots_per_s_warm"] is None
    trace = tmp_path / "steane_auto_steane_auto_p0.05.trace.json"
    assert trace.stat().st_size > 0
    assert line["trace_kernels"] == 0 and line["idle_share"] is None
    assert isinstance(line["trace_ms_per_chunk"], float)


def test_a_corrupted_counter_makes_the_line_incorrect(capsys, monkeypatch):
    """A pipeline that counts one decoder failure too many per chunk: the
    line is printed with `correct` false and the exit code is 1."""
    made = bench.make_pipeline

    def corrupted(case, Hx, Hz, cfg):
        pipe = made(case, Hx, Hz, cfg)
        count = pipe._count

        def bad_count(*args, **kwargs):
            counts = count(*args, **kwargs)
            counts["DecFailures_X"] = counts["DecFailures_X"] + 1
            return counts

        pipe._count = bad_count
        return pipe

    monkeypatch.setattr(bench, "make_pipeline", corrupted)
    (line,) = _lines(capsys, ["--config", "flagship", "--shots", "256"], rc=1)
    assert line["correct"] is False
    check = line["check"]
    assert check["run"]["DecFailures_X"] == check["plain"]["DecFailures_X"] + 1


def test_bp_check_is_within_four_sigma():
    """BP: qBLER within 4 sigma and at most `BP_DIFFER_MAX` of a side's
    shots decoded otherwise; MS, BF and NG: equal counters."""
    run = dict.fromkeys(EVENT_KEYS, 0)
    run.update(decSuccessExact=990, nIterAccX=5, nIterAccZ=5)
    near = dict(run, decSuccessExact=985)
    far = dict(run, decSuccessExact=900)
    few, many = {"x": 5, "z": 0}, {"x": 0, "z": 6}
    assert bench.check_verdict("BP", run, near, 1000, few)["correct"]
    assert not bench.check_verdict("BP", run, far, 1000, few)["correct"]
    assert not bench.check_verdict("BP", run, near, 1000, many)["correct"]
    assert not bench.check_verdict("BP", run, near, 1000)["correct"]
    assert not bench.check_verdict("MS", run, near, 1000)["correct"]
    assert bench.check_verdict("NG", run, dict(run), 1000)["correct"]


def test_bf16_state_fails_the_bp_check(capsys, monkeypatch):
    """The control: config 5 with the bf16 state (`QLDPC_QC_DTYPE=bf16`,
    qBLER within 4 sigma of float32) decodes more than `BP_DIFFER_MAX` of
    its shots otherwise than the float32 plain versions: the line is
    incorrect and the exit code 1 (float32 decodes every shot alike:
    `test_counters_equal_simulate_p`)."""
    monkeypatch.setenv("QLDPC_QC_DTYPE", "bf16")
    (line,) = _lines(capsys, ["--config", "config5_B", "--shots", "1024"],
                     rc=1)
    check = line["check"]
    assert line["decoders"] == ["QCDecoder:bf16", "QCDecoder:bf16"]
    assert check["qBLER_diff"] <= check["four_sigma"]
    assert max(check["differ"].values()) > check["differ_max"] == 5
    assert line["correct"] is False and line["timed_check"]["correct"]


def test_timed_run_is_held_to_its_invariants_and_the_check():
    """The timed run's counters: each event count within [0, shots], the
    disjoint events of a side within the shots, the iteration sums within
    shots x iterations, and qBLER within 4 sigma of the check's."""
    plain = dict.fromkeys(EVENT_KEYS, 0)
    plain.update(decSuccessExact=960, successStabilizer=980,
                 DecFailures_X=10, logicalErrors_X=5, nIterAccX=4000,
                 nIterAccZ=4000)
    timed = {k: 4 * v for k, v in plain.items()}
    assert bench.timed_verdict(timed, 4000, plain, 1000, 50)["correct"]
    for bad, why in [
            (dict(timed, DecFailures_Z=-1), "DecFailures_Z"),
            (dict(timed, decSuccessExact=4001), "decSuccessExact"),
            (dict(timed, DecFailures_X=100), "successStabilizer + "
             "DecFailures_X + logicalErrors_X <= shots"),
            (dict(timed, nIterAccZ=200_001), "nIterAccZ <= shots x "
             "iterations")]:
        verdict = bench.timed_verdict(bad, 4000, plain, 1000, 50)
        assert not verdict["correct"] and why in verdict["invariants_broken"]
    worse = dict(timed, decSuccessExact=3600, successStabilizer=3700)
    verdict = bench.timed_verdict(worse, 4000, plain, 1000, 50)
    assert verdict["invariants_broken"] == [] and not verdict["correct"]
    # iterations 0 (NG): no bound on the iteration sums
    assert bench.timed_verdict(dict(timed, nIterAccX=10 ** 9), 4000, plain,
                               1000, 0)["correct"]


def test_the_check_reaches_every_card_of_the_four_card_layout():
    """flagship_4card's check covers its first two 16,384-shot chunks, so
    each of the four slots of every chunk holds 4096 valid shots (the
    slots of a CPU mesh stand in for the cards)."""
    from qldpcsim_torch.engine.montecarlo import _slot_layout
    from qldpcsim_torch.parallel.mesh import make_mesh
    from qldpcsim_torch.utils.threefry import prng_key

    case = _case("flagship_4card")
    Hx, Hz = bench.matrices(case)
    cfg = bench.sim_config(case, case.shots[0], 0, "cpu",
                           make_mesh(["cpu"] * 4))
    pipe = ShotPipeline(Hx, Hz, cfg)
    assert pipe.batch == 16384 and pipe.per_dev == 4096
    n_check = bench.check_shots(case, case.shots[0], pipe.batch)
    assert n_check == 32768
    _, n_valid = _slot_layout(pipe, n_check, 0, 2, [prng_key(0)])
    assert np.asarray(n_valid).reshape(-1).tolist() == [4096] * 8
    # a shorter run is its own check
    assert bench.check_shots(case, 20000, pipe.batch) == 20000
    assert bench.check_shots(_case("config4"), 4 * bench.M, 4096) == 256


def test_idle_share_from_a_chrome_trace(tmp_path):
    """The union of the kernels' intervals over the span from the first
    start to the last end; other events do not count."""
    events = [{"cat": "kernel", "ts": 0, "dur": 10},
              {"cat": "kernel", "ts": 5, "dur": 15},      # overlaps: 0-20
              {"cat": "cpu_op", "ts": 20, "dur": 100},
              {"cat": "kernel", "ts": 30, "dur": 10},     # 30-40
              {"cat": "kernel", "ts": 32, "dur": 2},      # inside
              {"cat": "gpu_memcpy", "ts": 45, "dur": 5},
              {"cat": "kernel", "ts": 60, "dur": 4}]      # 60-64
    path = tmp_path / "t.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy, window = bench.union_share(bench.kernel_intervals(str(path)))
    assert (busy, window) == (34.0, 64.0)


def test_required_operations_per_shot():
    """Each side's average iterations times its decode matrix's edges times
    15 (MS) or 71 (BP), plus 84 per qubit's draw and 3 per syndrome edge;
    None for BF and NG."""
    code = get_code("lp118_0")
    Hx, Hz = np.asarray(code.Hx) % 2, np.asarray(code.Hz) % 2
    e = int(Hx.sum())
    assert e == int(Hz.sum()) == 1920
    assert bench.required_ops_per_shot("MS", Hx, Hz, 3.0, 2.0) == (
        15 * e * 5.0 + 84 * 544 + 3 * 2 * e)
    assert bench.required_ops_per_shot("BP", Hx, Hz, 1.0, 1.0) == (
        71 * e * 2.0 + 84 * 544 + 3 * 2 * e)
    assert bench.required_ops_per_shot("BF", Hx, Hz, 1.0, 1.0) is None


def test_the_card_is_the_default_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--config", "flagship", "--shots", "64"], script=SCRIPT)
    r = subprocess.run([sys.executable, SCRIPT, "--shots", "64"],
                       capture_output=True, text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_four_card_configuration_as_two_cpu_ranks(tmp_path):
    """flagship_4card with --chips 2 on the CPU: the script starts two
    ranks itself (`parallel/launch.py`), they sum their counters over gloo,
    and rank 0's one line equals one process's `simulate_p`."""
    out = tmp_path / "lines.jsonl"
    r = subprocess.run(
        [sys.executable, SCRIPT, "--device", "cpu", "--config",
         "flagship_4card", "--chips", "2", "--shots", "640", "--out",
         str(out)], capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    (line,) = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [json.loads(ln) for ln in r.stdout.splitlines()] == [line]
    assert line["chips"] == 2 and line["correct"] is True
    assert line["check"]["shots"] == 640
    code = get_code("lp118_0")
    ref = simulate_p(code.Hx, code.Hz, 0.05, SimConfig(
        shots=640, dec_type="MS", dec_iterations=50, dec_schedule="L",
        rng_seed=0, device="cpu"))
    assert _line_counters(line) == _port_counters(ref)


def test_all_skips_what_needs_more_cards(monkeypatch, capsys):
    """On the card, `all` reports a configuration that needs more cards
    than torch sees as skipped, and naming it alone raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench, "CONFIGS", ("flagship_4card",))
    from qldpcsim_torch.ops import _build
    monkeypatch.setattr(_build, "load_all", lambda *a, **k: None)
    assert bench.main(["--config", "all"], script=SCRIPT) == 0
    (line,) = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert line == {"config": "flagship_4card", "correct": None,
                    "skipped": "needs 4 cards, torch sees 1"}
    with pytest.raises(RuntimeError, match="needs 4 cards"):
        bench.main(["--config", "flagship_4card"], script=SCRIPT)
