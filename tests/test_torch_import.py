"""The PyTorch port imports no jax, nothing of the JAX package
`qldpcsim_tpu` and none of the tests' helpers: neither at import time
(checked in a fresh interpreter, since the test process has both loaded)
nor anywhere in its source or in the scripts that drive it (an AST
scan)."""

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
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "qldpcsim_tpu", "tests",
                                    "oracle", "refimport"))
print(",".join(bad))
"""


@pytest.mark.parametrize("imports", [
    "",
    "import qldpcsim_torch.engine.montecarlo, qldpcsim_torch.convert",
    "from qldpcsim_torch import simulate_p, SimConfig, codes, gf2",
    "import qldpcsim_torch.decoders.osd, qldpcsim_torch.ops.gf2_elim_cuda, "
    "qldpcsim_torch.utils.f32math",
    "import qldpcsim_torch.engine.montecarlo, qldpcsim_torch.codes, "
    "qldpcsim_torch.gf2, qldpcsim_torch.ops.qc",
    "from qldpcsim_torch import simulate; "
    "import qldpcsim_torch.ops.seq_qc_cuda, "
    "qldpcsim_torch.decoders.sequential, qldpcsim_torch.utils.checkpoint",
    "import qldpcsim_torch.ops.general_h_cuda, qldpcsim_torch.decoders.ms, "
    "qldpcsim_torch.decoders.bp, qldpcsim_torch.decoders.ms_mxu, "
    "qldpcsim_torch.decoders.bp_mxu, qldpcsim_torch.decoders.bf, "
    "qldpcsim_torch.decoders.ng, qldpcsim_torch.decoders.checknode",
    "import qldpcsim_torch.ops.flood_qc_cuda, qldpcsim_torch.channel.encoder, "
    "qldpcsim_torch.utils.profiling, qldpcsim_torch.utils.threefry",
    "import qldpcsim_torch.cli, qldpcsim_torch.__main__; "
    "from qldpcsim_torch.compat import decoders, simulator, gf2math, "
    "PCMlibrary; import qldpcsim_torch.compat.PMClibrary",
    "import qldpcsim_torch.parallel.mesh, qldpcsim_torch.codes.export_data; "
    "from qldpcsim_torch import simulate_sweep",
    "import qldpcsim_torch.parallel.launch",
    "import qldpcsim_torch.engine.group_cascade, qldpcsim_torch.gf2.native; "
    "from qldpcsim_torch import gf2; gf2.rank([[1, 1], [0, 1]])",
    "import qldpcsim_torch.utils.bench; import runpy; "
    "runpy.run_path('bench_torch.py', run_name='bench_torch')",
    "import qldpcsim_torch.utils.parity; import runpy; "
    "runpy.run_path('parity_torch.py', run_name='parity_torch')",
])
def test_import_leaves_jax_out(imports):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _PROBE.format(imports=imports)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", (
        f"jax or qldpcsim_tpu modules loaded: {out.stdout}")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_import_in_source():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "chip_mesh.py",
                                         ROOT / "chip_compare.py",
                                         ROOT / "chip_spans.py",
                                         ROOT / "bench_torch.py",
                                         ROOT / "parity_torch.py"]
    assert len(files) > 10
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"qldpcsim_torch/cli.py", "qldpcsim_torch/__main__.py",
            "qldpcsim_torch/compat.py", "qldpcsim_torch/channel/encoder.py",
            "qldpcsim_torch/utils/profiling.py",
            "qldpcsim_torch/ops/flood_qc_cuda.py",
            "qldpcsim_torch/parallel/mesh.py",
            "qldpcsim_torch/parallel/launch.py",
            "qldpcsim_torch/codes/export_data.py",
            "qldpcsim_torch/engine/group_cascade.py",
            "qldpcsim_torch/gf2/native.py",
            "qldpcsim_torch/utils/bench.py", "bench_torch.py",
            "qldpcsim_torch/utils/parity.py", "parity_torch.py"} <= names
    allowed_tpu = set()  # the port keeps its own copy of what it needs
    for f in files:
        for mod in _imported_modules(f):
            assert mod.split(".")[0] not in ("jax", "jaxlib"), f"{f}: {mod}"
            if mod.split(".")[0] == "qldpcsim_tpu":
                assert mod in allowed_tpu, f"{f} imports {mod}"
            # the test helpers (tests/oracle.py imports qldpcsim_tpu.gf2)
            assert mod.split(".")[0] not in ("tests", "oracle",
                                             "refimport"), f"{f}: {mod}"
