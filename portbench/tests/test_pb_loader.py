"""The check's decode reference as a configuration names it: the default
on a recorded chunk, a planted module, names refused at set-up, what the
reference modules import, and a serial-schedule cell added by files
alone."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from portbench import check, harness
from portbench.tests.test_pb_harness import (
    PB,
    ROOT,
    TINY,
    _add_cell,
    _copy_tree,
    _small_passes,  # noqa: F401 (the passes of a run, small here too)
    run,
    tiny,
)

DATA = PB / "data"
FORBIDDEN = {"jax", "jaxlib", "flax", "qldpcsim_tpu", "qldpcsim_torch"}


@pytest.fixture(autouse=True)
def _fresh_decoders():
    check._decoder.cache_clear()
    yield
    check._decoder.cache_clear()


def recorded_task():
    """A chunk of 256 shots of lp118_0 at p 0.05 as a run keeps it, the
    program's side made from the reference and then altered: one error bit
    of shot 5, and on each side one estimate bit of the first sampled shot,
    the iteration count of the second and the posteriors of the third to
    sixth (times 1.001)."""
    from portbench.reference import channel, decode

    Hx = np.load(DATA / "Hx_LP118_0.npy") % 2
    Hz = np.load(DATA / "Hz_LP118_0.npy") % 2
    seed, job, p, tile, n_tiles, first = 2**31 + 5, 3, 0.05, 64, 4, 8
    ex, ez = channel.sample(seed, job, p, 544, tile, first, n_tiles)
    sz, sx = channel.syndrome(Hz, ex), channel.syndrome(Hx, ez)
    sample = np.arange(0, 256, 4)
    prog = {}
    for side, H, s in (("x", Hz, sz), ("z", Hx, sx)):
        e, it, cv, post = decode.decode(H, s[sample], p, "MS", "L", 50)
        e, it, post = e.copy(), it.copy(), post.copy()
        e[0, 7] ^= 1
        it[1] += 1
        post[2:6] *= np.float32(1.001)
        prog[side] = (e, it, cv, post)
    ex = ex.copy()
    ex[5, 0] ^= 1
    return {"job": job, "Hx": str(DATA / "Hx_LP118_0.npy"),
            "Hz": str(DATA / "Hz_LP118_0.npy"), "seed": seed,
            "p_index": job, "p": p, "tile": tile, "n_tiles": n_tiles,
            "first_tile": first, "channel": (ex, ez, sz, sx),
            "sample": sample,
            "decoder": {"type": "MS", "schedule": "L", "iterations": 50,
                        "beta": 0.75, "eps": 1e-6},
            "decode": prog, "osd_order": -1, "osd": {}, "classify": []}


def test_default_reference_gives_the_numbers_it_gave():
    """A configuration without `reference` decodes with `decode`, and the
    recorded chunk reads as the check read it before the reference could
    be named (numbers recorded from that check)."""
    conf = json.loads((PB / "configs" / "lp118_msl50.json").read_text())
    assert "reference" not in conf
    assert harness.decode_reference(ROOT, conf) == "decode"
    assert harness.load_cell(ROOT, "lp118_msl50.p05").reference == "decode"
    r = check.check_chunk(dict(recorded_task(), reference="decode"))
    gaps = r.pop("gaps")
    r.pop("seconds")
    assert r == {"job": 3, "shots": 256, "channel_bad": 1, "pairs": 128,
                 "decode_bad": 4, "osd_shots": 0, "osd_bad": 0,
                 "classify_calls": 0, "classify_bad": 0}
    assert len(gaps) == 124 and float(np.median(gaps)) == 0.0
    assert float(np.sum(gaps)) == 0.007999678724445403
    assert max(gaps) == 0.0010000474285334349


PLANTED = '''
from portbench.reference import decode as _decode


def decode(H, syn, p, kind, schedule, max_iter, beta=0.75, eps=1e-6):
    e, it, cv, post = _decode.decode(H, syn, p, kind, schedule, max_iter,
                                     beta, eps)
    e = e.copy()
    e[0, 0] ^= 1              # one shot's decode, flipped
    return e, it, cv, post
'''


def test_planted_reference_that_flips_one_decode_is_not_correct(
        tmp_path, monkeypatch):
    root = _copy_tree(tmp_path)
    path = root / "portbench" / "reference" / "planted_flip.py"
    path.write_text(PLANTED)
    spec = importlib.util.spec_from_file_location(
        "portbench.reference.planted_flip", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    # the check in this process, where the planted module is loaded
    monkeypatch.setitem(sys.modules, "portbench.reference.planted_flip", mod)
    monkeypatch.setattr(check, "workers_available", lambda *a: 1)
    conf = json.loads((PB / "configs" / "lp118_msl50.json").read_text())
    conf.update(name="lp118_planted", reference={"decode": "planted_flip"})
    _add_cell(root, "lp118_planted.tiny", conf, {"p": 0.05, **TINY})
    cell = harness.load_cell(root, "lp118_planted.tiny")
    assert cell.reference == "planted_flip"
    res = run(cell)
    assert not res["correct"]
    assert res["check"]["decode_bad_share"]["value"] > 0
    sound = run(tiny("lp118_msl50.p05"))
    assert sound["correct"], sound["check"]


@pytest.mark.parametrize("name", ["decode.x", "reference/decode",
                                  "../decode", "decode_serial.py", "",
                                  "1decode", "no_such_module", 7])
def test_reference_name_refused_at_setup(tmp_path, name):
    root = _copy_tree(tmp_path)
    conf = json.loads((PB / "configs" / "lp118_msl50.json").read_text())
    conf.update(name="lp118_badref", reference={"decode": name})
    _add_cell(root, "lp118_badref.tiny", conf, {"p": 0.05, **TINY})
    with pytest.raises(harness.CellError, match="reference"):
        harness.load_cell(root, "lp118_badref.tiny")


def test_run_refuses_a_bad_reference_without_a_result(tmp_path):
    root = _copy_tree(tmp_path)
    conf = json.loads((PB / "configs" / "lp118_msl50.json").read_text())
    conf.update(name="lp118_badref", reference={"decode": "../decode"})
    _add_cell(root, "lp118_badref.tiny", conf, {"p": 0.05, **TINY})
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "lp118_badref.tiny", "--seed", "1", "--seconds",
                          "1"], cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "reference" in out.stderr


REFERENCES = sorted(p.stem for p in (PB / "reference").glob("*.py")
                    if p.stem != "__init__")


@pytest.mark.parametrize("name", REFERENCES)
def test_reference_module_loads_neither_program_nor_jax(name):
    """Imported as the check imports it, in a process of its own: no module
    of the program, of JAX or of the JAX package comes with it (by whole
    top-level names)."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import importlib\n"
            "importlib.import_module('portbench.reference.%s')\n"
            "print(sorted({m.partition('.')[0] for m in sys.modules}))\n"
            ) % (str(ROOT), name)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert "portbench" in tops and not tops & FORBIDDEN


def _lp04_tree(tmp_path, reference):
    """A copy of the benchmark with a serial-schedule cell on lp04_0 (a
    circulant-lifted code, lift 7) added as files and entries alone."""
    from qldpcsim_torch.codes import get_code

    root = _copy_tree(tmp_path)
    code = get_code("lp04_0")
    for side in ("Hx", "Hz"):
        np.save(root / "portbench" / "data" / f"{side}_LP04_0.npy",
                np.asarray(getattr(code, side)) % 2)
    conf = json.loads((PB / "configs" / "lp118_msl50.json").read_text())
    conf.update(name="lp04_mss12", reference={"decode": reference},
                code={"name": "lp04_0", "Hx": "portbench/data/Hx_LP04_0.npy",
                      "Hz": "portbench/data/Hz_LP04_0.npy"},
                decoder={"type": "MS", "schedule": "S", "iterations": 12,
                         "beta": 0.75},
                expect={"decoder": "SeqQCDecoder"})
    _add_cell(root, "lp04_mss12.p03", conf, {"p": 0.03, **TINY})
    return root


def test_a_serial_cell_comes_in_by_files_alone(tmp_path):
    """A configuration naming `decode_serial`, with schedule S on a small QC
    code, goes through set-up, the window and the check; kernel D's plain
    version equals the reference bit for bit there."""
    before = {p: p.read_bytes() for p in (PB / "harness.py",
                                          PB / "check.py")}
    root = _lp04_tree(tmp_path, "decode_serial")
    cell = harness.load_cell(root, "lp04_mss12.p03")
    assert cell.reference == "decode_serial"
    res = run(cell)
    assert res["correct"], res["check"]
    assert res["check"]["decode_bad_share"]["value"] == 0
    assert res["check"]["posterior_gap"]["value"] == 0
    assert {p: p.read_bytes() for p in before} == before
