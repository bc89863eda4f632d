"""Check-node updates of the plain-torch decoders (`ms.py`, `bp.py`,
`ms_mxu.py`, `bp_mxu.py`, `sequential.py`): one block of variable-to-check
messages in, the extrinsic check-to-variable messages out, as the
reference's XLA decoders write them."""

from __future__ import annotations

import torch

_TANH_FLOOR = 1e-12  # |tanh| floor: keeps the extrinsic quotient finite


def check_node(kind: str, mv: torch.Tensor, mask: torch.Tensor,
               ss: torch.Tensor, beta: float, clamp: float) -> torch.Tensor:
    """mv: (..., dmax) v2c messages of check rows, 0 at pad slots; mask:
    valid slots, broadcastable to mv; ss: (..., 1) syndrome sign, -1 where
    the check's syndrome bit is set. Returns the new c2v messages, 0 at pad
    slots.

    MS: beta-normalized min-sum; the magnitude of a slot is the row's
    second minimum where its own |v2c| equals the minimum, else the minimum
    (ties at the minimum all take the second, which then equals it);
    sign(0) = +1. BP: the tanh product with the slot's own factor divided
    out, |tanh| floored at 1e-12, the quotient clamped to +-clamp."""
    if kind == "MS":
        sign = 1.0 - 2.0 * (mv < 0).to(torch.float32)
        a = torch.where(mask, mv.abs(), torch.inf)
        min1 = a.min(dim=-1, keepdim=True).values
        # first position of the minimum, as the reference's argmin
        first = (a == min1).to(torch.int8).argmax(dim=-1, keepdim=True)
        min2 = a.scatter(-1, first, torch.inf).min(dim=-1,
                                                   keepdim=True).values
        min1 = torch.where(torch.isinf(min1), 0.0, min1)
        min2 = torch.where(torch.isinf(min2), 0.0, min2)
        parity = ((mv < 0) & mask).sum(dim=-1, keepdim=True)
        prod_sign = 1.0 - 2.0 * (parity & 1).to(torch.float32)
        mag = torch.where(mv.abs() == min1, min2, min1)
        out = beta * ss * prod_sign * sign * mag
    else:
        t = torch.tanh(mv * 0.5)
        t = torch.where(mask, t, 1.0)
        t = torch.where(t < 0, -1.0, 1.0) * torch.clamp_min(t.abs(),
                                                            _TANH_FLOOR)
        prod = t.prod(dim=-1, keepdim=True)
        th2 = torch.clamp(prod / t, -clamp, clamp)
        out = ss * 2.0 * torch.atanh(th2)
    return torch.where(mask, out, 0.0)
