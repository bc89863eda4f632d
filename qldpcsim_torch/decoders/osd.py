"""Batched ordered-statistics (OSD) post-decoder (port of
`qldpcsim_tpu/decoders/osd.py`).

For each decoder-failed shot: order the columns of H from least to most
reliable by the decoder's posterior, take the first rank(H) independent
columns in that order as the basis (one GF(2) elimination sweep, kernel C
on the card), and enumerate the 2^order flip patterns of the `order`
least-reliable information positions, solving the basis positions for each
through the elimination's tags; the lightest candidate wins, first wins on
ties. Like the reference, every one of the 2^order patterns is enumerated
on its own (the reference simulator's accumulating flips are a documented
divergence of the JAX package, which the port keeps).

Everything but the elimination is plain torch, as the reference leaves it
to XLA. Packed words are int64 tensors holding 32-bit words; the
reliability order is a stable argsort, as `jnp.argsort` is stable.
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch
from torch import nn

from qldpcsim_torch import gf2
from qldpcsim_torch.convert import osd_static_from_reference
from qldpcsim_torch.ops import gf2_elim_cuda
from qldpcsim_torch.ops.gf2_elim_cuda import bit_at, words_to_int64, xor_fold

_LLR_SAT = 100.0
MAX_ORDER = 6


@dataclasses.dataclass(frozen=True)
class OSDStatic:
    """Static (data-independent) OSD quantities of one H, as the
    reference's `OSDStatic` (numpy; `convert.osd_static_from_reference`
    turns either into the port's tensors)."""

    m: int
    n: int
    r: int      # rank(H)
    mW: int     # 32-bit words covering m
    rW: int     # 32-bit words covering r
    cols_packed: np.ndarray  # (n, mW) uint32: column j of H, bits over checks

    @staticmethod
    def build(H: np.ndarray) -> "OSDStatic":
        H = (np.asarray(H) % 2).astype(np.uint8)
        m, n = H.shape
        r = gf2.rank(H)
        mW = max(1, -(-m // 32))
        rW = max(1, -(-max(r, 1) // 32))
        padded = np.zeros((mW * 32, n), dtype=np.uint64)
        padded[:m] = H
        weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
        cols = (padded.reshape(mW, 32, n) * weights[None, :, None]).sum(
            axis=1).T.astype(np.uint32)
        return OSDStatic(m=m, n=n, r=r, mW=mW, rW=rW,
                         cols_packed=np.ascontiguousarray(cols))


def pack_bits(bits: torch.Tensor, W: int) -> torch.Tensor:
    """(B, <= 32 W) 0/1 -> (B, W) int64 words, LSB first."""
    B, m = bits.shape
    pad = W * 32 - m
    if pad:
        bits = torch.cat([bits, bits.new_zeros((B, pad))], dim=1)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    return (bits.to(torch.int64).view(B, W, 32) * weights).sum(dim=-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int64 tensor."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def reliability_order(posterior: torch.Tensor) -> torch.Tensor:
    """(B, n) posterior LLRs -> (B, n) column order, least reliable first:
    a stable ascending argsort of max(q, 1 - q), q = 1 / (1 + exp(llr)) on
    LLRs saturated at +-100 (the reference's, osd.py:241-244)."""
    llr = posterior.to(torch.float32).clamp(-_LLR_SAT, _LLR_SAT)
    prob = torch.reciprocal(1.0 + torch.exp(llr))
    reliability = torch.maximum(prob, 1.0 - prob)
    return torch.argsort(reliability, dim=-1, stable=True)


class OSD(nn.Module):
    """osd(e_hat, syndromes, posterior) -> e_hat' for OSD-`order` over H
    (the reference's `make_osd`). Inputs are batched over decoder-failed
    shots: e_hat (B, n) integer, syndromes (B, m) 0/1, posterior (B, n)
    float32, all on the module's device. Returns (B, n) int8."""

    def __init__(self, H: np.ndarray, order: int, device="cpu"):
        super().__init__()
        order = int(order)
        if order < 0:
            raise ValueError(f"osd order must be >= 0, got {order}")
        if order > MAX_ORDER:
            # as the reference: 2^order candidates, each a full solve
            raise ValueError(
                f"osd order {order} > {MAX_ORDER}: the 2^order candidate "
                "enumeration would explode the run time; reference OSD-λ "
                "enumerates 2^λ patterns on the λ least-reliable "
                "information positions (λ <= 2 is typical)")
        H = (np.asarray(H) % 2).astype(np.int8)
        tables = osd_static_from_reference(OSDStatic.build(H), device=device)
        self.order = order
        self.r, self.mW, self.rW = tables.r, tables.mW, tables.rW
        # kernel C's launch, fixed here from the basis size: its threads,
        # row stride, mapping and whether the basis lies in shared memory
        # or in `elim_scratch` (device memory, grown to the largest window)
        self.elim_plan = gf2_elim_cuda.plan(self.r, self.mW, self.rW)
        self._scratch = None
        self.register_buffer("cols", tables.cols)
        self.register_buffer("H_T", torch.as_tensor(
            np.ascontiguousarray(H.T), dtype=torch.float32, device=device))

    def elim_scratch(self, B: int, device):
        """Kernel C's basis for B shots when the plan puts it in device
        memory (None otherwise): int32 words, a view of a buffer kept on
        the module."""
        if not self.elim_plan.state_on_device or device.type != "cuda":
            return None
        need = B * self.r * self.elim_plan.stride
        s = self._scratch
        if s is None or s.device != device or s.numel() < need:
            s = torch.empty(need, dtype=torch.int32, device=device)
            self._scratch = s
        return s[:need]

    def forward(self, e_hat: torch.Tensor, syndromes: torch.Tensor,
                posterior: torch.Tensor) -> torch.Tensor:
        B, n = e_hat.shape
        mW = self.mW
        i64 = torch.int64
        e = e_hat.to(i64)

        # 1. reliability order, least reliable first
        perm = reliability_order(posterior)                       # (B, n)

        # 2. least-reliable basis: one elimination sweep
        colsP = self.cols[perm]                                   # (B, n, mW)
        tags32, pivots, sel = gf2_elim_cuda.eliminate(
            colsP, self.r, self.rW, self.elim_plan,
            self.elim_scratch(B, colsP.device))
        tags = words_to_int64(tags32)
        pivots = pivots.to(i64)
        pivots_valid = pivots >= 0
        colsP = words_to_int64(colsP)

        # 3. s0 = syndrome + H e_info (the estimate off the basis)
        e_perm = e.gather(1, perm)
        e_info_perm = torch.where(sel, 0, e_perm)
        e_info = torch.zeros_like(e).scatter(1, perm, e_info_perm)
        s_info = torch.remainder(e_info.to(torch.float32) @ self.H_T, 2.0)
        s0 = torch.remainder(syndromes.to(torch.float32) + s_info, 2.0)
        s0P = pack_bits(s0.to(i64), mW)                            # (B, mW)

        # 4. the `order` lowest-indexed information positions
        crank = torch.cumsum((~sel).to(i64), dim=-1)
        flip_pos, flip_colP, flip_ebit = [], [], []
        for k in range(self.order):
            posk = (crank == k + 1).to(torch.int32).argmax(dim=-1)  # (B,)
            flip_pos.append(posk)
            flip_colP.append(colsP.gather(
                1, posk[:, None, None].expand(B, 1, mW))[:, 0])
            flip_ebit.append(e_perm.gather(1, posk[:, None])[:, 0])
        base_info_w = e_info_perm.sum(dim=-1)

        # 5. 2^order candidates, first wins on ties
        best_weight = best_x = best_w = None
        for w in range(2 ** self.order):
            sJ, winfo = s0P, base_info_w
            for k in range(self.order):
                if (w >> k) & 1:
                    sJ = sJ ^ flip_colP[k]
                    winfo = winfo + 1 - 2 * flip_ebit[k]
            hm = -bit_at(sJ, pivots, pivots_valid)
            x = xor_fold(tags & hm[:, :, None], 1)                 # (B, rW)
            weight = popcount32(x).sum(dim=-1) + winfo
            if best_weight is None:
                best_weight, best_x = weight, x
                best_w = torch.zeros_like(weight)
            else:
                better = weight < best_weight
                best_weight = torch.where(better, weight, best_weight)
                best_x = torch.where(better[:, None], x, best_x)
                best_w = torch.where(better, w, best_w)

        # 6. reconstruct the winner and undo the permutation
        slot_of = torch.cumsum(sel.to(i64), dim=-1) - 1
        xbits = bit_at(best_x, slot_of, sel)
        flipmask = torch.zeros_like(e)
        iota_n = torch.arange(n, device=e.device)
        for k in range(self.order):
            sel_k = (best_w >> k) & 1
            flipmask = flipmask ^ ((iota_n[None, :] == flip_pos[k][:, None])
                                   .to(i64) * sel_k[:, None])
        e_perm_new = torch.where(sel, xbits, e_perm ^ flipmask)
        inv_perm = torch.empty_like(perm).scatter_(
            1, perm, iota_n.expand(B, n).contiguous())
        return e_perm_new.gather(1, inv_perm).to(torch.int8)
