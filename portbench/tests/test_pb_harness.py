"""The harness on the CPU: the runs' check against broken timed paths, a
cell added by files and entries alone, two ranks over gloo, the metric
readers, the contract of BENCHMARK.json, and the guards (no card, no
program, no JAX)."""

import ast
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "qldpcsim_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"shots_per_job_per_card": 512, "shots_per_card_chunk": 256}


@pytest.fixture(autouse=True)
def _small_passes(monkeypatch):
    monkeypatch.setattr(harness, "WARM_CHUNKS", 1)
    monkeypatch.setattr(harness, "LAYER_CHUNKS", 1)
    monkeypatch.setattr(harness, "TRACE_CHUNKS", 1)


def tiny(name, p=None, root=ROOT, decode_shots=64):
    cell = harness.load_cell(root, name)
    cell.traffic = dict(cell.traffic, **TINY, **({"p": p} if p else {}))
    cell.config["check"] = dict(cell.config["check"],
                                decode_shots_per_job=decode_shots)
    return cell


def cpu_part(cell, seed=2**31 + 11, break_it=None, trace=False,
             control=False):
    """One CPU run's part, the timed path broken by `break_it(session)`
    after set-up."""
    from portbench.capture import Capture

    s = harness.Session(cell, seed, device="cpu", control=control)
    s.setup()
    if break_it is not None:      # beneath the check's capture
        s.capture.remove()
        break_it(s)
        s.capture = Capture(s.slot)
    win = s.window(0.01)
    part = {"rank": 0, "world": 1, "seed": seed, "setup_parts": s.parts,
            "window": win, "device": "cpu", "check": s.check(1),
            "forbidden": [], "shapes": {"edges_x": 1920, "edges_z": 1920}}
    if trace:
        part["layer"], part["trace"] = s.layer_pass(), s.trace_pass()
    return part


def run(cell, trace=False, **kw):
    """One CPU run's result line (`cpu_part`'s arguments)."""
    return harness.result(cell, [cpu_part(cell, trace=trace, **kw)], 0.0,
                          trace)


CELLS = ["lp118_msl50.p05", "lp118_bposd2.p03", "lp118_msl50.p01"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = run(tiny(name))
    assert res["correct"], res["check"]
    assert res["metrics"] == {}          # no CPU number under a metric's name
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The configuration's control, the program's bf16 decoder state."""
    res = run(tiny(name), control=True)
    assert not res["correct"]
    assert res["check"]["posterior_gap"]["value"] > \
        res["check"]["posterior_gap"]["limit"]


def _decoder_fault(kind):
    def install(s):
        from qldpcsim_torch.decoders.common import DecodeResult

        for dec in (s.slot.dec_x, s.slot.dec_z):
            fwd = dec.forward

            def broken(syn, p, fwd=fwd):
                r = fwd(syn, p)
                if kind == "unchanged":   # the state left as it started
                    return DecodeResult(
                        e_hat=torch.zeros_like(r.e_hat),
                        n_iter=torch.ones_like(r.n_iter),
                        converged=torch.ones_like(r.converged),
                        posterior=torch.full_like(r.posterior, 4.0))
                e = r.e_hat.clone()       # every answer altered
                e[:, 0] ^= 1
                return DecodeResult(e_hat=e, n_iter=r.n_iter,
                                    converged=r.converged,
                                    posterior=r.posterior)

            dec.forward = broken
    return install


def _half_batch(s):
    """Each side decodes the first half of a chunk's shots; the second half
    takes the first half's results."""
    from qldpcsim_torch.decoders.common import DecodeResult

    for dec in (s.slot.dec_x, s.slot.dec_z):
        fwd = dec.forward

        def broken(syn, p, fwd=fwd):
            h = (syn.shape[0] + 1) // 2
            r = fwd(syn[:h], p)
            idx = torch.arange(syn.shape[0]) % h
            return DecodeResult(e_hat=r.e_hat[idx], n_iter=r.n_iter[idx],
                                converged=r.converged[idx],
                                posterior=r.posterior[idx])

        dec.forward = broken


def _half_chunks(s):
    """Every second chunk of a job left out, the counts of the chunk before
    it standing in for it."""
    seen = []

    def wrap(name, pair):
        fn = getattr(s.slot, name)

        def broken(*args):
            if len(seen) % 2:
                seen.append(None)
                counts = {k: v.clone() for k, v in next(
                    c for c in reversed(seen) if c is not None).items()}
                return (counts, None) if pair else counts
            out = fn(*args)
            seen.append(out[0] if pair else out)
            return out

        setattr(s.slot, name, broken)

    wrap("_chunk_body", False)
    if s.slot.use_osd:
        wrap("_chunk_body_defer", True)


def _channel_fault(s):
    fn = s.slot._sample_chunk

    def broken(keys, p):
        ex, ez, sz, sx = fn(keys, p)
        ex = ex.clone()
        ex[0, 0] ^= 1
        return ex, ez, sz, sx

    s.slot._sample_chunk = broken


def _osd_fault(s):
    fn = s.slot._apply_osd

    def broken(osd, e_hat, post, syn, failed):
        out = fn(osd, e_hat, post, syn, failed).clone()
        out[:, 0] ^= failed.to(out.dtype)
        return out

    s.slot._apply_osd = broken


FAULTS = {"state unchanged": (_decoder_fault("unchanged"), "decode_bad_share"),
          "answer altered": (_decoder_fault("altered"), "decode_bad_share"),
          "half the batch": (_half_batch, "decode_bad_share"),
          "half the chunks": (_half_chunks, "counters_bad"),
          "channel altered": (_channel_fault, "channel_bad")}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(name, fault):
    break_it, number = FAULTS[fault]
    res = run(tiny(name), break_it=break_it)
    assert not res["correct"]
    assert res["check"][number]["value"] > res["check"][number]["limit"]


def test_osd_fault_is_not_correct():
    """OSD's answers altered where they are produced, at a p where many
    shots reach it (in the chunk and in the group-level pass)."""
    res = run(tiny("lp118_bposd2.p03", p=0.07), break_it=_osd_fault)
    assert res["check"]["osd_bad"]["value"] > 0 and not res["correct"]
    # BP itself departs from the reference at this p (its trajectories run
    # long): only OSD's number is held here
    sound = run(tiny("lp118_bposd2.p03", p=0.07))
    assert sound["check"]["osd_bad"]["value"] == 0


def test_traced_run_reports_no_cpu_number():
    res = run(tiny("lp118_bposd2.p03"), trace=True)
    assert res["correct"] and res["metrics"] == {}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_printed_lines(capsys):
    """The info lines (the seed, the window's jobs and CPU time), the numbers
    compared last on standard error, and the result as the last line."""
    cell = tiny("lp118_msl50.p01")
    part = cpu_part(cell, seed=2**33 + 7)
    assert harness.print_result(cell, [part], 0.0, False) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert lines[0].startswith("# cell lp118_msl50.p01") and \
        lines[0].endswith(f"seed {2**33 + 7}")
    assert any(x.startswith("# window CPU rank 0: the process used ")
               for x in lines)
    assert json.loads(lines[-1])["correct"] is True
    assert err.strip().splitlines()[-1].startswith("check counters_bad ")


def _copy_tree(dst: Path) -> Path:
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(PB, dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return dst


def _digests(root: Path):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _add_cell(root: Path, name, config, traffic, chips=1):
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    (root / "portbench" / "configs" / f"{config['name']}.json").write_text(
        json.dumps(config))
    (root / "portbench" / "traffic" / f"{name.split('.')[1]}.json"
     ).write_text(json.dumps(traffic))
    bench["configs"].append({"name": config["name"], "source": "test",
                             "file": f"portbench/configs/{config['name']}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": config["name"],
                               "traffic": name.split(".")[1], "chips": chips,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def _children():
    """The processes whose parent is this one."""
    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                if int(f.read().rsplit(")", 1)[1].split()[1]) == me:
                    out.append(int(d))
        except (OSError, ValueError, IndexError):
            pass
    return out


def _marked(entry):
    """The processes other than this one whose environment holds
    `entry`."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/environ", "rb") as f:
                if entry.encode() + b"\0" in f.read() + b"\0":
                    out.append(int(d))
        except OSError:
            pass
    return out


def _drop_seconds(results):
    return [{k: v for k, v in r.items() if k != "seconds"} for r in results]


def test_check_workers_leave_no_process():
    """The check's worker processes give what one process gives, in the
    tasks' order, and none outlives the call: not on success, and not when
    a worker fails."""
    from portbench import check

    s = harness.Session(tiny("lp118_msl50.p05"), 2**31 + 29, device="cpu")
    s.setup()
    s.window(0.01)
    tasks, _ = s.tasks()
    tasks = tasks + [dict(t, job=t["job"] + 100) for t in tasks]
    before = set(_children())
    alone = check.run_tasks(tasks, 1)
    split = check.run_tasks(tasks, 3)
    assert [r["job"] for r in split] == [t["job"] for t in tasks]
    assert _drop_seconds(split) == _drop_seconds(alone)
    assert set(_children()) <= before
    with pytest.raises(RuntimeError, match="check worker"):
        check.run_tasks(tasks[:1] + [dict(tasks[0], Hx="no/such.npy")], 2)
    assert set(_children()) <= before


def test_a_cell_added_by_files_and_entries_alone(tmp_path):
    root = _copy_tree(tmp_path)
    before = _digests(root)
    conf = json.loads((PB / "configs" / "lp118_msl50.json").read_text())
    conf.update(name="lp118_msf20", decoder=dict(
        conf["decoder"], schedule="F", iterations=20))
    _add_cell(root, "lp118_msf20.tiny", conf,
              {"p": 0.06, **TINY})
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items()
               if k != "BENCHMARK.json")
    bench_before = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench_after = json.loads((root / "BENCHMARK.json").read_text())
    for key in bench_before:      # entries only added
        if isinstance(bench_before[key], list):
            assert bench_after[key][:len(bench_before[key])] == \
                bench_before[key]
    res = run(harness.load_cell(root, "lp118_msf20.tiny"))
    assert res["correct"], res["check"]
    assert res["check"]["decode_bad_share"]["value"] == 0


RANK_WRAPPER = """
import sys
sys.path.insert(0, {root!r})
from qldpcsim_torch.parallel import mesh
if {broken!r}:
    mesh.allreduce_counters_host = lambda counts: counts
from portbench import harness
for k, v in dict(WARM_CHUNKS=1, LAYER_CHUNKS=1, TRACE_CHUNKS=1).items():
    setattr(harness, k, v)
from portbench import rank
sys.exit(rank.main(sys.argv[1:]))
"""


@pytest.mark.parametrize("broken", [False, True])
def test_two_ranks_over_gloo(tmp_path, broken):
    """A cell over two CPU ranks through the program's launcher, and the
    same with the exchange between them left out."""
    from qldpcsim_torch.parallel.launch import launch_local

    root = _copy_tree(tmp_path / "tree")
    conf = json.loads((PB / "configs" / "lp118_msl50_4card.json").read_text())
    conf.update(name="lp118_msl50_2slot", chips=2)
    _add_cell(root, "lp118_msl50_2slot.tiny", conf, {"p": 0.05, **TINY},
              chips=2)
    wrapper = tmp_path / "rank_wrapper.py"
    wrapper.write_text(RANK_WRAPPER.format(root=str(ROOT), broken=broken))
    out = tmp_path / "out"
    out.mkdir()
    mark = f"{os.getpid()}x{tmp_path.name}"
    env = {"OMP_NUM_THREADS": "1", "PORTBENCH_TEST_MARK": mark}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        rc = launch_local(2, ["--workload", "lp118_msl50_2slot.tiny",
                              "--seed", "12345", "--seconds", "0.01",
                              "--out", str(out), "--root", str(root),
                              "--device", "cpu", "--trace", "1"],
                          prog=(str(wrapper),))
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    assert rc == 0
    assert _marked(f"PORTBENCH_TEST_MARK={mark}") == []   # all ended
    parts = [json.loads((out / f"part.{r}.json").read_text())
             for r in range(2)]
    cell = harness.load_cell(root, "lp118_msl50_2slot.tiny")
    res = harness.result(cell, parts, 0.0, True)
    assert res["correct"] is (not broken)
    assert (res["check"]["counters_bad"]["value"] > 0) is broken
    assert res["attempted"] == 512 * 2


@pytest.mark.parametrize("chips", [1, 2])
def test_readings(tmp_path, chips):
    """`readings.py` on a cell of one process, and of two CPU ranks: the
    sound seed within the limits, the control's posterior gap above its
    limit."""
    root = _copy_tree(tmp_path / "tree")
    conf = json.loads((PB / "configs" / "lp118_msl50_4card.json").read_text())
    conf.update(name=f"lp118_msl50_{chips}slot", chips=chips)
    name = f"lp118_msl50_{chips}slot.tiny"
    _add_cell(root, name, conf, {"p": 0.05, **TINY}, chips=chips)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "portbench/readings.py", "--workload",
         name, "--seconds", "0.01", "--seeds", "41",
         "--control-seeds", "42", "--device", "cpu"], cwd=root, env=env,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    sound, control = [json.loads(x) for x in out.stdout.strip().splitlines()]
    limits = conf["check"]["limits"]
    assert sound["seed"] == 41 and not sound["control"]
    assert all(v <= limits[k] for k, v in sound["numbers"].items())
    assert sound["jobs"] == 1 and sound["pairs"] > 0
    assert control["control"] and \
        control["numbers"]["posterior_gap"] > limits["posterior_gap"]


def _obs(layer_s, busy, kernels):
    from portbench import yardstick

    return {"cell": {"name": "x", "chips": 1,
                     "decoder": {"type": "MS"}},
            "yardstick": yardstick,
            "window": {"seconds": 2.0, "chunks": 512, "shots": 2 << 20,
                       "host_syncs": 2048, "wait_s": 0.0},
            "layer": {"shots": 4096 * 64, "iters_x": 900000,
                      "iters_z": 800000,
                      "seconds": None if layer_s is None else {
                          n: layer_s for n in ("channel", "decode_x",
                                               "decode_z", "osd",
                                               "classify")}},
            "trace": {"shots": 4096 * 16, "chunks": 16, "busy_s": busy,
                      "kernels": kernels, "window_s": 0.1},
            "shapes": {"edges_x": 1920, "edges_z": 1920},
            "ranks": [{"window": {"seconds": 2.0, "wait_s": 0.1}},
                      {"window": {"seconds": 2.0, "wait_s": 0.2}}]}


def _metrics():
    return json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]


@pytest.mark.parametrize("metric", [m["name"] for m in _metrics()])
def test_reader_reads_or_returns_nothing(metric):
    read = harness.load_reader(ROOT, metric)
    value = read(_obs(0.05, 0.02, 3000))
    assert value is not None and value > 0 and np.isfinite(value)
    if metric != "rank_skew" and metric != "host_syncs_per_kshot":
        assert read(_obs(None, 0.0, 0)) is None
    unit = {m["name"]: m["unit"] for m in _metrics()}[metric]
    if unit == "%":
        assert value <= 100


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    cells = {w["name"]: w for w in bench["workloads"]}
    confs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]
                                                       ).is_file()
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in confs and w["chips"] in (1, 4)
        assert (PB / "traffic" / f"{w['traffic']}.json").is_file()
        assert len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert (PB / "metrics" / f"{m['name']}.py").is_file()
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:   # every cell: setup_s, another end-to-end, a layer
        assert sum(cell in m.get("workloads", cells)
                   for m in bench["end_to_end"]) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in bench["per_layer"])
    assert len(json.dumps(bench)) <= 64 * 1024


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(PB).as_posix()
                                        for p in PB.rglob("*.py")))
def test_no_file_imports_jax(path):
    tops = {m.partition(".")[0] for m in _imports(PB / path)}
    assert not tops & FORBIDDEN
    if path.startswith("reference/"):
        assert "qldpcsim_torch" not in tops
        assert tops <= {"numpy", "portbench", "__future__", "dataclasses",
                        "typing"}


def test_a_run_loads_no_jax():
    """The modules of a CPU run of the harness, compared by whole
    top-level names."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "harness.WARM_CHUNKS = 1\n"
        "cell = harness.load_cell(sys.path[0], 'lp118_msl50.p01')\n"
        "cell.traffic = dict(cell.traffic, shots_per_job_per_card=256, "
        "shots_per_card_chunk=256)\n"
        "p = harness.rank_part(cell, 3, 0.01, False, device='cpu')\n"
        "print(sorted({m.partition('.')[0] for m in sys.modules}))\n"
    ) % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "qldpcsim_torch" in tops and not tops & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlike_pkg", sys)
    monkeypatch.setitem(sys.modules, "qldpcsim_tpu_extra.sub", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def _run_py(cwd):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "lp118_msl50.p05", "--seed", "1", "--seconds",
                           "1"], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_no_card_fails_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_fails_without_a_result(tmp_path):
    root = _copy_tree(tmp_path)
    out = _run_py(root)
    assert out.returncode != 0 and out.stdout.strip() == ""
