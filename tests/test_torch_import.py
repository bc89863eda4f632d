"""The PyTorch port imports no jax: neither at import time (checked in a
fresh interpreter, since the test process has jax loaded) nor anywhere in
its source (an AST scan)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "qldpcsim_torch"

_PROBE = """
import sys
import qldpcsim_torch
{imports}
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print(",".join(bad))
"""


@pytest.mark.parametrize("imports", [
    "",
    "import qldpcsim_torch.engine.montecarlo, qldpcsim_torch.convert",
    "from qldpcsim_torch import simulate_p, SimConfig, codes, gf2",
])
def test_import_leaves_jax_out(imports):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE.format(imports=imports)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"jax modules loaded: {out.stdout}"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import_in_source():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    allowed_tpu = {"qldpcsim_tpu.codes", "qldpcsim_tpu.gf2",
                   "qldpcsim_tpu.ops.qc"}
    for f in files:
        for mod in _imported_modules(f):
            assert mod.split(".")[0] not in ("jax", "jaxlib"), f"{f}: {mod}"
            if mod.startswith("qldpcsim_tpu"):
                assert mod in allowed_tpu, f"{f} imports {mod}"
