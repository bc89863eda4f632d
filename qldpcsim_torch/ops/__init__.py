"""Hand-written CUDA kernels (`qldpcsim_torch/csrc/*.cu`), their wrappers and
plain PyTorch versions, and the static QC structure they exploit.

  * `channel_cuda` — the threefry depolarizing channel (kernel A);
  * `ms_qc_cuda`   — min-sum and BP over a circulant-lifted H (kernel B);
  * `gf2_elim_cuda` — OSD's batched GF(2) elimination (kernel C);
  * `seq_qc_cuda`  — serial (row-sequential) min-sum and BP over a
    circulant-lifted H (kernel D);
  * `general_h_cuda` — min-sum and BP over any H with contiguous layers
    (kernel E);
  * `flood_qc_cuda` — slot-stacked flooding min-sum and BP over a
    circulant-lifted H (kernel F);
  * `_build`       — builds the `.cu` sources with nvcc and loads them.

Each wrapper counts its launches in its module's `LAUNCHES`;
`launch_counts()` reads them all.
"""

from qldpcsim_torch.ops.qc import QCStructure, detect_qc

__all__ = ["QCStructure", "detect_qc", "launch_counts"]


def launch_counts() -> dict:
    """The launches of every kernel in this process so far, by kernel and
    kind ("channel syndromes": kernel A's launches that formed the
    syndromes too)."""
    from qldpcsim_torch.ops import (channel_cuda, flood_qc_cuda,
                                    general_h_cuda, gf2_elim_cuda, ms_qc_cuda,
                                    seq_qc_cuda)

    counts = {"channel": channel_cuda.LAUNCHES,
              "channel syndromes": channel_cuda.SYN_LAUNCHES,
              "gf2_elim": gf2_elim_cuda.LAUNCHES}
    for name, mod in (("ms_qc", ms_qc_cuda), ("seq_qc", seq_qc_cuda),
                      ("general_h", general_h_cuda),
                      ("flood_qc", flood_qc_cuda)):
        for kind, n in mod.LAUNCHES.items():
            counts[f"{name} {kind}"] = n
    return counts
