"""Batched syndrome decoders (port of `qldpcsim_tpu/decoders`).

The port carries normalized min-sum (MS) and tanh-product sum-product (BP):
over circulant-lifted (QC) parity-check matrices under the flooding (F) and
layered (L) schedules (`ops/ms_qc_cuda.py`, kernel B) and the serial (S)
schedule in natural row order (`ops/seq_qc_cuda.py`, kernel D); over any
matrix under a one-row-per-layer schedule (`decoders/sequential.py`, plain
torch); wrapped in the straggler cascade; and the OSD post-decoder
(`decoders/osd.py`). Every other decoder, schedule or matrix raises
`NotImplementedError` naming the ROADMAP slice that brings it.
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


def _factory(graph, cfg, eff_layers, kind, device):
    """Decoder factory (MS or BP) for `graph` under `cfg.schedule` and
    `cfg.impl`, as the reference's `make_decoder` chooses it, without its
    TPU gate: on a CUDA device a kernel runs, on the CPU its plain version.
    Raises NotImplementedError for what the port does not carry yet."""
    from qldpcsim_torch.decoders import sequential
    from qldpcsim_torch.ops.ms_qc_cuda import make_qc_decoder
    from qldpcsim_torch.ops.qc import detect_qc, layers_align_blocks
    from qldpcsim_torch.ops.seq_qc_cuda import (
        make_seq_qc_decoder,
        serial_order_is_natural,
    )

    sched = cfg.schedule.upper()
    if sched not in ("F", "L", "S"):
        raise ValueError("Unrecognized decoder scheduling option.")
    if cfg.impl not in ("auto", "qc", "seq"):
        raise NotImplementedError(
            f"impl={cfg.impl!r}: the edge and general-H paths come with the "
            "non-QC slice (ROADMAP queue 1, 'Non-QC codes')")

    def seq_factory(graph2, cfg2, layers=None):
        return sequential.make_seq_decoder(graph2, cfg2, layers=layers,
                                           kind=kind, device=device)

    if cfg.impl == "seq":
        if not sequential.supports(eff_layers):
            raise ValueError("seq path requires a serial (1-row-layer) "
                             "schedule")
        return seq_factory
    st = detect_qc(graph.H)
    if sched == "S":
        if st is not None and serial_order_is_natural(eff_layers, graph.m):
            def factory(graph2, cfg2, layers=None):
                return make_seq_qc_decoder(st, cfg2, layers=layers,
                                           device=device, kind=kind)

            return factory
        if cfg.impl == "qc":
            raise ValueError("serial qc kernel requires a circulant-"
                             "lifted H with natural-order 1-row layers")
        if sequential.supports(eff_layers):
            return seq_factory
        raise NotImplementedError(
            "a serial schedule with layers of more than one row needs the "
            "edge decoder (ROADMAP queue 1, 'Non-QC codes')")
    if st is None or (sched == "L"
                      and not layers_align_blocks(eff_layers, st)):
        if cfg.impl == "qc":
            raise ValueError("qc kernel requires a circulant-lifted H with "
                             "block-row-aligned layers")
        if st is None:
            raise NotImplementedError(
                "H is not circulant-lifted: non-QC codes under F and L come "
                "with the general-H slice (ROADMAP queue 1, 'Non-QC codes')")
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
    factory = _factory(graph, cfg, eff_layers, kind, device)
    r1 = cfg.round1_iters
    if r1 < 0 or cfg.max_iter <= 12:
        return factory(graph, cfg, layers=eff_layers)
    if r1 > 0:
        return make_tworound(factory, graph, cfg, eff_layers, r1,
                             cfg.compact_cap_frac)
    return make_cascade(factory, graph, cfg, eff_layers)
