"""`python -m qldpcsim_torch.codes.export_data` writes the `data/` files:
every file it writes equals the checked-in file of the same stem byte for
byte (int64, the same header), and the JAX package's `export` writes the
same files."""

import os
import subprocess
import sys

import numpy as np

from qldpcsim_tpu.codes import export_data as ref_export_data

from qldpcsim_torch.codes import export_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_export_writes_the_checked_in_files(tmp_path):
    written = export_data.export(str(tmp_path / "port"))
    names = [os.path.basename(p) for p in written]
    assert len(names) == 22 == len(set(names))
    assert {"Hx_bicycle.npy", "Hz_bicycle.npy", "Hx_T.npy",
            "Hz_LP118_0.npy"} <= set(names)
    for path in written:
        data = os.path.join(REPO, "data", os.path.basename(path))
        assert np.load(path).dtype == np.int64
        with open(path, "rb") as a, open(data, "rb") as b:
            assert a.read() == b.read(), path


def test_export_equals_the_jax_package_export(tmp_path):
    ours = export_data.export(str(tmp_path / "port"))
    theirs = ref_export_data.export(str(tmp_path / "ref"))
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a


def test_module_entry_point(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "qldpcsim_torch.codes.export_data",
         str(tmp_path)], capture_output=True, text=True, timeout=120,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.split()
    assert len(lines) == 22 and all(os.path.exists(p) for p in lines)
