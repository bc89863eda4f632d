"""Reference-compatible API shims (port of `qldpcsim_tpu/compat.py`).

A user of the reference package can switch imports and keep their code:

    from qLDPCsim import decoders, PCMlibrary, gf2math, simulator
        -> from qldpcsim_torch.compat import decoders, PCMlibrary, gf2math, simulator

Signatures, argument names, defaults and return conventions are the
reference's; computation is this package's batched path with batch size 1
for the per-shot decoder calls. Every function that decodes or simulates
takes a trailing keyword `device="cuda"`: the card by default (it raises
when torch sees none), `"cpu"` for the plain PyTorch versions. Notes:

  * NG/BF/MS/BP return (e_hat, n_iter) as numpy and int; `layers` accepts
    the reference's list of row-index arrays (the `layerize` output).
  * BF_decoder uses the reference simulator's any-overlap "bool" residual,
    so it is shot-for-shot drop-in, unlike the engine, whose default is the
    standard mod-2 parity residual (`DecoderConfig.bf_residual`).
  * OSDdec never mutates its arguments and enumerates all 2^order patterns.
  * simulator.build_stim_circuit does not exist here by design: the GF(2)
    channel (`qldpcsim_torch.channel`) replaces the Stim circuit layer;
    calling it raises with that explanation.
  * gf2math.REF returns (B, T) with B = (T @ A) % 2.
"""

from __future__ import annotations

import sys
import types

import numpy as np


# --------------------------------------------------------------------------
# gf2math
# --------------------------------------------------------------------------

def _gf2math_module():
    from qldpcsim_torch import gf2

    mod = types.ModuleType("qldpcsim_torch.compat.gf2math")

    def rank(A):
        return gf2.rank(np.asarray(A))

    def REF(A, reduced=False):
        B, T, _ = gf2.ref(np.asarray(A), reduced=reduced)
        return B, T

    def nullSpace(A):
        return gf2.null_space(np.asarray(A))

    def rowBasis(M):
        return gf2.row_basis(np.asarray(M))

    def systematic_form(H):
        return gf2.systematic_form(np.asarray(H))

    mod.rank, mod.REF, mod.nullSpace = rank, REF, nullSpace
    mod.rowBasis, mod.systematic_form = rowBasis, systematic_form
    return mod


# --------------------------------------------------------------------------
# PCMlibrary (the reference's __init__ exports the misspelled name
# `PMClibrary`: both spellings work here)
# --------------------------------------------------------------------------

def _pcm_module():
    from qldpcsim_torch.codes import (
        bicycle_code,
        qc_ldpc_lifted_code,
        qc_ldpc_tanner_code,
        shor_code,
        steane_code,
    )

    mod = types.ModuleType("qldpcsim_torch.compat.PCMlibrary")
    mod.shor_code = shor_code
    mod.steane_code = steane_code
    mod.bicycle_code = bicycle_code
    mod.qc_ldpc_tanner_code = qc_ldpc_tanner_code
    mod.qc_ldpc_lifted_code = qc_ldpc_lifted_code
    return mod


# --------------------------------------------------------------------------
# decoders: per-shot signatures
# --------------------------------------------------------------------------

def _decoders_module():
    import torch

    from qldpcsim_torch.decoders import (
        DecoderConfig,
        LayerSchedule,
        TannerGraph,
        layerize,
        make_decoder,
        make_osd,
    )
    from qldpcsim_torch.engine.montecarlo import _resolve_device

    mod = types.ModuleType("qldpcsim_torch.compat.decoders")
    mod.layerize = layerize

    def _layers_sched(H, layers):
        if layers is None:
            return None
        m = np.asarray(H).shape[0]
        return LayerSchedule.from_layers([np.asarray(l) for l in layers], m)

    def _run(dec_type, H, syndrome, p=0.01, max_iter=99, layers=None,
             beta=0.75, OSDorder=-1, eps=1e-9, bf_max_iter=50,
             bf_residual="bool", device="cuda"):
        dev = _resolve_device(device)
        H = np.asarray(H) % 2
        graph = TannerGraph.build(H)
        # explicit layers mean a layered decode with the reference's exit
        # after every layer, also where a circulant-lifted H takes kernel B
        # (which under "F" would pass over `layers`)
        cfg = DecoderConfig(dec_type=dec_type, max_iter=max_iter,
                            schedule="F" if layers is None else "L",
                            beta=beta, eps=max(eps, 1e-6),
                            bf_max_iter=bf_max_iter, bf_residual=bf_residual,
                            qc_check_every="layer")
        dec = make_decoder(graph, cfg, layers=_layers_sched(H, layers),
                           device=dev)
        syn = torch.as_tensor(np.asarray(syndrome).reshape(1, -1) % 2,
                              dtype=torch.int8, device=dev)
        r = dec(syn, p)
        e = r.e_hat
        n_it = int(r.n_iter[0])
        if OSDorder >= 0 and not bool(r.converged[0]):
            e = make_osd(H, OSDorder, device=dev)(e, syn, r.posterior[:1])
        return e[0].cpu().numpy(), n_it

    def NG_decoder(H, syndrome, device="cuda"):
        return _run("NG", H, syndrome, device=device)

    def BF_decoder(H, syndrome, max_iter=50, device="cuda"):
        # drop-in means reference-exact: the reference simulator's
        # any-overlap "bool" residual, unlike the engine's mod2 default
        return _run("BF", H, syndrome, bf_max_iter=max_iter,
                    bf_residual="bool", device=device)

    def MS_decoder(H, syndrome, p, max_iter=99, layers=None, beta=0.75,
                   OSDorder=-1, eps=1e-9, device="cuda"):
        return _run("MS", H, syndrome, p=p, max_iter=max_iter, layers=layers,
                    beta=beta, OSDorder=OSDorder, eps=eps, device=device)

    def BP_decoder(H, syndrome, p, max_iter=99, layers=None, OSDorder=-1,
                   eps=1e-9, device="cuda"):
        return _run("BP", H, syndrome, p=p, max_iter=max_iter, layers=layers,
                    OSDorder=OSDorder, eps=eps, device=device)

    def OSDdec(H, e_hat, syndrome, posteriorLLRs, order, device="cuda"):
        # inputs are not mutated
        dev = _resolve_device(device)
        H = np.asarray(H) % 2

        def row(a, dtype):
            return torch.as_tensor(np.asarray(a).reshape(1, -1), dtype=dtype,
                                   device=dev)

        e = make_osd(H, int(order), device=dev)(
            row(e_hat, torch.int8), row(syndrome, torch.int8),
            row(np.asarray(posteriorLLRs, np.float32), torch.float32))
        return e[0].cpu().numpy()

    mod.NG_decoder, mod.BF_decoder = NG_decoder, BF_decoder
    mod.MS_decoder, mod.BP_decoder, mod.OSDdec = MS_decoder, BP_decoder, OSDdec
    return mod


# --------------------------------------------------------------------------
# simulator
# --------------------------------------------------------------------------

def _simulator_module():
    from qldpcsim_torch.cli import main as _main
    from qldpcsim_torch.codes.loader import load_matrix
    from qldpcsim_torch.engine.montecarlo import SimConfig
    from qldpcsim_torch.engine.montecarlo import simulate as _simulate
    from qldpcsim_torch.engine.montecarlo import simulate_p as _simulate_p

    mod = types.ModuleType("qldpcsim_torch.compat.simulator")
    mod.load_matrix = load_matrix
    mod.main = _main

    def simulate(HxFile, HzFile, p, shots=1000, decType="MS",
                 decIterations=99, decSchedule="F", OSDorder=-1,
                 rngSeed=None, device="cuda"):
        # the reference's signature; returns the per-p results list instead
        # of None
        return _simulate(HxFile, HzFile, p, shots=shots, decType=decType,
                         decIterations=decIterations, decSchedule=decSchedule,
                         OSDorder=OSDorder, rngSeed=rngSeed, device=device)

    def simulate_p(Hx, Hz, p, shots=1000, decType="MS", decIterations=99,
                   decSchedule="F", OSDorder=-1, rngSeed=None, device="cuda"):
        # returns the reference's counters dict
        cfg = SimConfig(shots=shots, dec_type=decType,
                        dec_iterations=decIterations,
                        dec_schedule=decSchedule, osd_order=OSDorder,
                        rng_seed=rngSeed, device=device)
        r = _simulate_p(np.asarray(Hx), np.asarray(Hz), float(p), cfg)
        return {
            "DecFailures_X": r.counters["DecFailures_X"],
            "DecFailures_Z": r.counters["DecFailures_Z"],
            "decSuccessExact": r.counters["decSuccessExact"],
            "decSuccessDegen": r.counters["decSuccessDegen"],
            "Avg_number_of_iterations_X": r.avg_iterations_x,
            "Avg_number_of_iterations_Z": r.avg_iterations_z,
        }

    def build_stim_circuit(*a, **k):
        raise NotImplementedError(
            "build_stim_circuit is intentionally absent: the Stim circuit "
            "layer is replaced by the native GF(2) channel "
            "(qldpcsim_torch.channel).")

    mod.simulate, mod.simulate_p = simulate, simulate_p
    mod.build_stim_circuit = build_stim_circuit
    return mod


gf2math = _gf2math_module()
PCMlibrary = _pcm_module()
PMClibrary = PCMlibrary  # the reference __init__'s typo, kept working
decoders = _decoders_module()
simulator = _simulator_module()

# Register as importable submodules: `from qldpcsim_torch.compat import X`
# and `import qldpcsim_torch.compat.X` both work.
for _name, _mod in (("gf2math", gf2math), ("PCMlibrary", PCMlibrary),
                    ("PMClibrary", PMClibrary), ("decoders", decoders),
                    ("simulator", simulator)):
    sys.modules[f"{__name__}.{_name}"] = _mod

__all__ = ["gf2math", "PCMlibrary", "PMClibrary", "decoders", "simulator"]
