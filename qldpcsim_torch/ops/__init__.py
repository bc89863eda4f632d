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
"""

from qldpcsim_torch.ops.qc import QCStructure, detect_qc

__all__ = ["QCStructure", "detect_qc"]
