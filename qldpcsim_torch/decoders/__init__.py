"""Batched syndrome decoders (port of `qldpcsim_tpu/decoders`).

Decoder families: NG (naive-greedy, `ng.py`), BF (bit-flipping, `bf.py`),
MS (normalized min-sum) and BP (tanh-product sum-product), the last two
under the flooding (F), layered (L) and serial (S) schedules, wrapped in the
straggler cascade when the iteration budget is deep and one full-depth call
would not do (`_one_launch`), and the OSD post-decoder (`osd.py`). `make_decoder` routes MS and BP as the reference
does, without its TPU gate (on a CUDA device a kernel runs, on the CPU its
plain version):

  * a circulant-lifted (QC) H: kernel B under F and block-row-aligned L
    (`ops/ms_qc_cuda.py`), kernel D under S in natural row order
    (`ops/seq_qc_cuda.py`);
  * else kernel E (`ops/general_h_cuda.py`, any H with contiguous layers):
    by itself for MS under L with at least 512 edge slots, and for
    `impl="gh"` with MS or BP under F or L;
  * else the row-sequential decoder (`sequential.py`) for one-row layers,
    when `impl="seq"` or there are more than 8 layers;
  * else the incidence decoders (`ms_mxu.py`, `bp_mxu.py`) for contiguous
    layers, at most 48 of them;
  * else, and for `impl="edge"`, the edge-layout decoders (`ms.py`,
    `bp.py`).
"""

import torch

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
    "make_osd",
]

# Fewest edge slots (m * dmax) at which `impl="auto"` takes kernel E over
# the incidence decoder (the reference's floor).
_GH_MIN_EDGES = 512


def _qc_factory(graph, cfg, eff_layers, kind, device):
    """Factory of the circulant-lifted kernels' decoders (kernel B under F
    and L, kernel D under S), or None when H or the schedule does not fit;
    `impl="qc"` raises instead."""
    if cfg.impl not in ("auto", "qc"):
        return None
    from qldpcsim_torch.ops.qc import detect_qc, layers_align_blocks

    st = detect_qc(graph.H)
    sched = cfg.schedule.upper()
    if sched == "S":
        from qldpcsim_torch.ops.seq_qc_cuda import (
            make_seq_qc_decoder,
            serial_order_is_natural,
        )

        if st is None or not serial_order_is_natural(eff_layers, graph.m):
            if cfg.impl == "qc":
                raise ValueError("serial qc kernel requires a circulant-"
                                 "lifted H with natural-order 1-row layers")
            return None

        def factory(graph2, cfg2, layers=None):
            return make_seq_qc_decoder(st, cfg2, layers=layers,
                                       device=device, kind=kind)

        return factory
    if st is None or (sched == "L"
                      and not layers_align_blocks(eff_layers, st)):
        if cfg.impl == "qc":
            raise ValueError("qc kernel requires a circulant-lifted H with "
                             "block-row-aligned layers")
        return None
    from qldpcsim_torch.ops.ms_qc_cuda import make_qc_decoder

    def factory(graph2, cfg2, layers=None):
        return make_qc_decoder(st, cfg2, layers=layers, device=device)

    return factory


def _gh_factory(graph, cfg, eff_layers, kind, device):
    """Factory of kernel E's decoder, or None. `impl="auto"` takes it for
    MS under L only, from `_GH_MIN_EDGES` edge slots on; `impl="gh"` forces
    it for MS and BP under F and L, and raises where it does not apply."""
    sched = cfg.schedule.upper()
    if sched not in ("F", "L"):
        if cfg.impl == "gh":
            raise ValueError("gh kernel supports MS/BP with schedule F/L")
        return None
    if cfg.impl not in ("auto", "gh"):
        return None
    if cfg.impl == "auto" and (sched != "L" or kind != "MS"):
        return None
    from qldpcsim_torch.ops.general_h_cuda import make_gh_decoder, supports

    if not supports(graph.H, eff_layers if sched == "L" else None):
        if cfg.impl == "gh":
            raise ValueError("gh kernel needs contiguous layers and a check "
                             "row with an edge (see general_h_cuda.supports)")
        return None
    if cfg.impl == "auto":
        H = graph.H
        if H.shape[0] * int(H.sum(axis=1).max()) < _GH_MIN_EDGES:
            return None

    def factory(graph2, cfg2, layers=None):
        return make_gh_decoder(graph2.H, cfg2, layers=layers, device=device,
                               kind=kind)

    return factory


def _factory(graph, cfg, eff_layers, kind, device):
    """Decoder factory (MS or BP) for `graph` under `cfg.schedule` and
    `cfg.impl`, in the reference's order of preference."""
    from qldpcsim_torch.decoders import bp, bp_mxu, ms, ms_mxu, sequential

    def with_device(make):
        def factory(graph2, cfg2, layers=None):
            return make(graph2, cfg2, layers=layers, device=device)

        return factory

    edge = with_device(ms.make_ms_decoder if kind == "MS"
                       else bp.make_bp_decoder)
    if cfg.impl not in ("auto", "mxu", "seq", "qc", "gh"):
        return edge     # "edge", and, as in the reference, any other name
    factory = (_qc_factory(graph, cfg, eff_layers, kind, device)
               or _gh_factory(graph, cfg, eff_layers, kind, device))
    if factory is not None:
        return factory
    if sequential.supports(eff_layers) and (cfg.impl == "seq"
                                            or eff_layers.n_layers > 8):
        return with_device(sequential.make_ms_seq_decoder if kind == "MS"
                           else sequential.make_bp_seq_decoder)
    if ms_mxu.supports(graph, eff_layers):
        return with_device(ms_mxu.make_ms_mxu_decoder if kind == "MS"
                           else bp_mxu.make_bp_mxu_decoder)
    if cfg.impl == "mxu":
        raise ValueError("mxu path requires contiguous layers and <=48 of "
                         f"them (got {eff_layers.n_layers})")
    if cfg.impl == "seq":
        raise ValueError("seq path requires a serial (1-row-layer) schedule")
    return edge


def _one_launch(decoder, device) -> bool:
    """Whether one full-depth call of `decoder` on `device` is enough: the
    decoder reports `one_launch` (a kernel whose every shot leaves the
    launch at its own convergence, measured against the cascade's stages on
    the card) and `device` is a CUDA device. The plain versions run their
    batch in lockstep until every shot has converged, so on the CPU the
    cascade's stages save work."""
    return (torch.device(device).type == "cuda"
            and getattr(decoder, "one_launch", False))


def make_decoder(graph, cfg, layers=None, device="cpu"):
    """decode(syndromes, p) -> DecodeResult for `cfg.dec_type` over `graph`
    (the reference's `make_decoder`).

    Syndromes are (B, m) tensors on `device`. Deep iteration budgets of MS
    and BP get the straggler cascade (decoders/cascade.py), unless the
    full-depth decoder alone is enough there (`_one_launch`)."""
    from qldpcsim_torch.decoders.cascade import make_cascade, make_tworound

    kind = cfg.dec_type.upper()
    if kind == "BF":
        from qldpcsim_torch.decoders.bf import make_bf_decoder

        return make_bf_decoder(graph, cfg, device=device)
    if kind == "NG":
        from qldpcsim_torch.decoders.ng import make_ng_decoder

        return make_ng_decoder(graph, cfg, device=device)
    if kind not in ("MS", "BP"):
        raise ValueError("Unrecognized decoder type.")
    eff_layers = (layers if layers is not None
                  else build_layers(graph.H, cfg.schedule.upper()))
    factory = _factory(graph, cfg, eff_layers, kind, device)
    full = factory(graph, cfg, layers=eff_layers)
    r1 = cfg.round1_iters
    if r1 < 0 or cfg.max_iter <= 12 or _one_launch(full, device):
        return full
    if r1 > 0:
        return make_tworound(factory, graph, cfg, eff_layers, r1,
                             cfg.compact_cap_frac)
    return make_cascade(factory, graph, cfg, eff_layers)


def make_osd(H, order: int, device="cpu"):
    """osd(e_hat, syndromes, posterior) -> e_hat' for OSD-`order` over H
    (the reference's `make_osd`): the `OSD` module of `decoders/osd.py` on
    `device`."""
    from qldpcsim_torch.decoders.osd import OSD

    return OSD(H, order, device=device)
