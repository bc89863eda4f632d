"""Batched syndrome decoders (port of `qldpcsim_tpu/decoders`).

The port carries normalized min-sum (MS) and tanh-product sum-product (BP)
over circulant-lifted (QC) parity-check matrices under the flooding (F) and
layered (L) schedules, wrapped in the straggler cascade, and the OSD
post-decoder (`decoders/osd.py`). Every other decoder, schedule or matrix
raises `NotImplementedError` naming the ROADMAP slice that brings it.
"""

from qldpcsim_torch.decoders.common import (
    DecodeResult,
    DecoderConfig,
    LayerSchedule,
    TannerGraph,
    build_layers,
    layerize,
)

__all__ = [
    "TannerGraph",
    "LayerSchedule",
    "layerize",
    "build_layers",
    "DecoderConfig",
    "DecodeResult",
    "make_decoder",
]

_LATER = {
    "BF": "BF comes with the non-QC slice (ROADMAP queue 1, 'Non-QC codes')",
    "NG": "NG comes with the non-QC slice (ROADMAP queue 1, 'Non-QC codes')",
}


def _qc_factory(graph, cfg, eff_layers, device):
    """QC decoder factory (MS or BP) for `graph`, or raise
    NotImplementedError for what this slice does not carry (the reference's
    `_try_qc_factory`, without its TPU gate: on a CUDA device the kernel
    runs, on the CPU its plain version)."""
    from qldpcsim_torch.ops.ms_qc_cuda import make_qc_decoder
    from qldpcsim_torch.ops.qc import detect_qc, layers_align_blocks

    sched = cfg.schedule.upper()
    if sched == "S":
        raise NotImplementedError(
            "the serial schedule comes with the config-4 slice (ROADMAP "
            "queue 1, 'Config 4')")
    if sched not in ("F", "L"):
        raise ValueError("Unrecognized decoder scheduling option.")
    if cfg.impl not in ("auto", "qc"):
        raise NotImplementedError(
            f"impl={cfg.impl!r}: the edge and general-H paths come with the "
            "non-QC slice (ROADMAP queue 1, 'Non-QC codes')")
    st = detect_qc(graph.H)
    if st is None:
        raise NotImplementedError(
            "H is not circulant-lifted: non-QC codes come with the general-H "
            "slice (ROADMAP queue 1, 'Non-QC codes')")
    if sched == "L" and not layers_align_blocks(eff_layers, st):
        raise NotImplementedError(
            "layers that do not align with block-rows need the edge decoder "
            "(ROADMAP queue 1, 'Non-QC codes')")

    def factory(graph2, cfg2, layers=None):
        return make_qc_decoder(st, cfg2, layers=layers, device=device)

    return factory


def make_decoder(graph, cfg, layers=None, device="cpu"):
    """decode(syndromes, p) -> DecodeResult for `cfg.dec_type` over `graph`
    (the reference's `make_decoder`).

    Syndromes are (B, m) tensors on `device`. Deep iteration budgets get the
    straggler cascade (decoders/cascade.py)."""
    from qldpcsim_torch.decoders.cascade import make_cascade, make_tworound

    kind = cfg.dec_type.upper()
    if kind in _LATER:
        raise NotImplementedError(_LATER[kind])
    if kind not in ("MS", "BP"):
        raise ValueError("Unrecognized decoder type.")
    eff_layers = (layers if layers is not None
                  else build_layers(graph.H, cfg.schedule.upper()))
    factory = _qc_factory(graph, cfg, eff_layers, device)
    r1 = cfg.round1_iters
    if r1 < 0 or cfg.max_iter <= 12:
        return factory(graph, cfg, layers=eff_layers)
    if r1 > 0:
        return make_tworound(factory, graph, cfg, eff_layers, r1,
                             cfg.compact_cap_frac)
    return make_cascade(factory, graph, cfg, eff_layers)
