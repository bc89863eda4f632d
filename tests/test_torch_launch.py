"""`--mesh` without a launcher starts one process per card
(`qldpcsim_torch/parallel/launch.py`): `launch_local` runs the command line
as n ranks of one gloo process group, rank 0's table is the run's output
and its counters equal the unmeshed run's; a rank that fails ends the run
with its status and its peer killed; a process under a launcher never
launches again; the CLI asks for ranks only on the card with more than one
card in sight. On the CPU (ranks of `--device cpu`); the card's run is
`chip_mesh.py`'s phase 4."""

import json
import os
import sys
import time
import warnings

import pytest
import torch

from qldpcsim_torch import cli
from qldpcsim_torch.parallel import launch
from qldpcsim_torch.parallel.mesh import Mesh, per_device_multi_chunk_fn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_launcher(monkeypatch):
    for k in launch.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.mark.parametrize("shard", [["--mesh"], ["--mesh-p", "2"]])
def test_two_ranks_print_rank0_table_with_the_unmeshed_counters(
        shard, tmp_path, capfd, no_launcher, monkeypatch):
    """Shots over two ranks (--mesh), or the p-points two at a time on two
    ranks (--mesh-p 2): rank 0's rows equal the unmeshed runs', per p."""
    from qldpcsim_torch.codes import get_code
    from qldpcsim_torch.engine.montecarlo import SimConfig, simulate_p

    monkeypatch.setenv("QLDPC_LAUNCH_COUNTS", str(tmp_path / "launches"))
    out = tmp_path / "res.jsonl"
    ps = [0.03] if shard == ["--mesh"] else [0.02, 0.04]
    rc = launch.launch_local(2, [
        "--code", "steane", "--p", *map(str, ps), "--shots", "700",
        "--batch", "256", "--decIterations", "10", "--rngSeed", "3",
        "--device", "cpu", *shard, "--quiet", "--out", str(out)])
    assert rc == 0
    printed = capfd.readouterr().out
    assert printed.count("SIMULATION RESULTS") == 1
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [row["p"] for row in rows] == ps
    code = get_code("steane")
    for i, (row, p) in enumerate(zip(rows, ps)):
        ref = simulate_p(code.Hx, code.Hz, p, SimConfig(
            shots=700, batch_size=256, dec_iterations=10, rng_seed=3,
            device="cpu"), p_index=i)
        assert {k: row[k] for k in ref.counters} == ref.counters
    for rank in range(2):  # both ranks ran, in one process group
        assert (tmp_path / f"launches.{rank}").exists()


def test_a_failing_rank_ends_the_run_and_kills_its_peer(
        tmp_path, capfd, no_launcher, monkeypatch):
    """Rank 1 fails at once; rank 0 would wait (here 600 s, as at the
    rendezvous). The launcher returns rank 1's non-zero status within
    seconds, with rank 0 killed. The ranks run a stand-in entry point
    found first on their path (the working directory)."""
    shim = tmp_path / "shim"
    (shim / "qldpcsim_torch").mkdir(parents=True)
    (shim / "qldpcsim_torch" / "__init__.py").write_text("")
    (shim / "qldpcsim_torch" / "__main__.py").write_text(
        "import os, sys, time\n"
        "if os.environ['RANK'] == '1':\n"
        "    sys.exit('rank 1 fails at import')\n"
        "open(os.environ['PIDFILE'], 'w').write(str(os.getpid()))\n"
        "time.sleep(600)\n")
    monkeypatch.setenv("PIDFILE", str(tmp_path / "pid0"))
    monkeypatch.chdir(shim)
    t0 = time.monotonic()
    rc = launch.launch_local(2, ["--code", "steane"])
    secs = time.monotonic() - t0
    assert rc == 1 and secs < 60
    assert "rank 1 fails at import" in capfd.readouterr().err
    if (tmp_path / "pid0").exists():
        pid = int((tmp_path / "pid0").read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_the_real_entry_point_failing_on_every_rank_returns_nonzero(
        tmp_path, no_launcher, capfd):
    rc = launch.launch_local(2, [
        "--Hx", str(tmp_path / "missing.npy"), "--Hz",
        str(tmp_path / "missing.npy"), "--p", "0.01", "--device", "cpu",
        "--mesh", "--quiet"])
    assert rc != 0
    assert "missing.npy" in capfd.readouterr().err


@pytest.mark.parametrize("env", [{}, {"LOCAL_RANK": "0"}, {"RANK": "1"},
                                 {"MASTER_PORT": "1234"}])
def test_a_process_under_a_launcher_does_not_launch_again(
        env, no_launcher, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert launch.launched() == bool(env)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    args = cli.build_parser().parse_args(["--code", "steane", "--p", "0.1",
                                          "--mesh"])
    assert cli.ranks_to_launch(args) == (0 if env else 4)


@pytest.mark.parametrize("flags,cards,ranks", [
    (["--mesh"], 4, 4),
    (["--mesh-p", "2"], 2, 2),
    (["--mesh"], 1, 0),
    (["--mesh"], 0, 0),
    (["--mesh", "--device", "cpu"], 4, 0),
    ([], 4, 0),
])
def test_cli_gate_launches_only_on_several_cards(
        flags, cards, ranks, no_launcher, monkeypatch):
    """Nothing launches here: `launch_local` is replaced by a recorder."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(launch, "launch_local",
                        lambda n, argv: calls.append((n, list(argv))) or 7)
    argv = ["--code", "steane", "--p", "0.1", *flags]
    if ranks:
        assert cli.main(argv) == 7
        assert calls == [(ranks, argv)]
    else:
        assert cli.ranks_to_launch(cli.build_parser().parse_args(argv)) == 0
        assert calls == []


def test_one_process_over_several_cards_warns():
    """A mesh of two cards in one process warns that it is slower than one
    card and names the way out; one card's slots, or CPU slots, do not.
    No slot thread starts: nothing is run."""
    two = Mesh(devices=(torch.device("cuda", 0), torch.device("cuda", 1)),
               size=2)
    with pytest.warns(RuntimeWarning, match="--nproc-per-node 2"):
        per_device_multi_chunk_fn(two, [None, None], ["nShots"])
    for devs in ((torch.device("cuda", 0),) * 2, (torch.device("cpu"),) * 2):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            per_device_multi_chunk_fn(Mesh(devices=devs, size=2),
                                      [None, None], ["nShots"])


def test_launch_needs_a_rank():
    with pytest.raises(ValueError):
        launch.launch_local(0, [])
