"""qldpcsim_torch — the quantum-LDPC Monte Carlo engine on PyTorch and CUDA.

The PyTorch counterpart of `qldpcsim_tpu` (the JAX reference, which stays in
the repository unchanged). Modules mirror the reference's layout and names:

  * `codes`, `gf2`, `ops.qc` — the code library, GF(2) algebra and QC
    structure detection (numpy only; the port's own copies);
  * `utils.threefry`, `parallel.keys` — the reference's threefry key chain
    (seed -> p-index -> global tile), bit-exact;
  * `channel` — the depolarizing channel and syndromes;
  * `decoders` — min-sum and BP over any parity-check matrix under the
    flooding, layered and serial schedules (the circulant-lifted and
    general-H kernels, the row-sequential, incidence and edge-layout
    decoders), bit-flipping and naive-greedy, the windowed straggler
    cascade, and the OSD post-decoder;
  * `engine` — classification counters and the Monte-Carlo loop
    (`ShotPipeline`, `simulate_p`, and the p-sweep `simulate`);
  * `ops` — the hand-written CUDA kernels (`csrc/*.cu`) and their plain
    PyTorch versions.

On a CUDA device every kernel of the path runs; on CPU tensors the plain
PyTorch versions run. Nothing here imports jax or `qldpcsim_tpu`.
"""

from qldpcsim_torch.version import __version__

__all__ = [
    "__version__",
    "codes",
    "gf2",
    "channel",
    "decoders",
    "engine",
    "parallel",
    "ops",
    "utils",
    "convert",
    "simulate",
    "simulate_p",
    "SimConfig",
]


def __getattr__(name):
    # Lazy imports keep `import qldpcsim_torch` cheap (no torch import on
    # startup), as in the reference package.
    import importlib

    if name in ("codes", "gf2", "channel", "decoders", "engine", "parallel",
                "ops", "utils", "convert"):
        return importlib.import_module(f"qldpcsim_torch.{name}")
    if name in ("simulate", "simulate_p", "SimConfig"):
        mod = importlib.import_module("qldpcsim_torch.engine.montecarlo")
        return getattr(mod, name)
    raise AttributeError(f"module 'qldpcsim_torch' has no attribute {name!r}")
