"""Hand-written CUDA kernels (`qldpcsim_torch/csrc/*.cu`), their wrappers and
plain PyTorch versions, and the static QC structure they exploit.

  * `channel_cuda` — the threefry depolarizing channel (kernel A);
  * `ms_qc_cuda`   — normalized min-sum over a circulant-lifted H (kernel B);
  * `_build`       — builds the `.cu` sources with nvcc and loads them.
"""

from qldpcsim_torch.ops.qc import QCStructure, detect_qc

__all__ = ["QCStructure", "detect_qc"]
