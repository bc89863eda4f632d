"""Edge-layout sum-product BP decoder (port of `qldpcsim_tpu/decoders/bp.py`):
kind BP of `ms.EdgeDecoder`, which holds the layer loop both kinds share;
the tanh-product update is `checknode.check_node`."""

from __future__ import annotations

from typing import Optional

from qldpcsim_torch.decoders.common import (
    DecoderConfig,
    LayerSchedule,
    TannerGraph,
)
from qldpcsim_torch.decoders.ms import EdgeDecoder


def make_bp_decoder(graph: TannerGraph, cfg: DecoderConfig,
                    layers: Optional[LayerSchedule] = None,
                    device="cpu") -> EdgeDecoder:
    return EdgeDecoder(graph, cfg, layers=layers, kind="BP", device=device)
