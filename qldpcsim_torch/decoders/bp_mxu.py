"""Incidence-product sum-product BP decoder (port of
`qldpcsim_tpu/decoders/bp_mxu.py`): kind BP of `ms_mxu.MxuDecoder`, which
holds the layer loop both kinds share; the tanh-product update is
`checknode.check_node`."""

from __future__ import annotations

from typing import Optional

from qldpcsim_torch.decoders.common import (
    DecoderConfig,
    LayerSchedule,
    TannerGraph,
)
from qldpcsim_torch.decoders.ms_mxu import MxuDecoder


def make_bp_mxu_decoder(graph: TannerGraph, cfg: DecoderConfig,
                        layers: Optional[LayerSchedule] = None,
                        device="cpu") -> MxuDecoder:
    return MxuDecoder(graph, cfg, layers=layers, kind="BP", device=device)
