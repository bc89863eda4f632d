"""Float32 arithmetic as XLA's CPU backend computes it: its natural log on
the host, and a correctly rounded fused multiply-add on tensors.

The reference forms the decoder's channel LLR with a float32 `jnp.log`,
which XLA:CPU lowers to its own polynomial (`GenerateVF32Log`, Cephes
coefficients, the family of Eigen's `plog_float`), not to a correctly
rounded log: the two differ by one ulp on about 5 % of float32 inputs.
`xla_cpu_logf` reproduces it operation by operation in float32, including
the multiply-adds that LLVM contracts into fused multiply-adds, so that the
port's prior equals the reference's bit for bit. It is one scalar per p
point, so it is written for clarity, not speed.

`fma_f32_torch` is the same fused multiply-add elementwise on tensors, for
the plain versions of kernels whose reference contracts a multiply and an
add (torch has no float32 fma of its own).
"""

from __future__ import annotations

import math

import numpy as np
import torch

f32 = np.float32

_SQRTHF = f32(0.707106781186547524)
_P = [f32(c) for c in (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
                       -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
                       2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)]
_Q1 = f32(-2.12194440e-4)
_Q2 = f32(0.693359375)
_MIN_NORMAL = np.uint32(0x00800000).view(f32)


def fma_f32(a, b, c) -> np.float32:
    """Correctly rounded float32 fused multiply-add.

    The product of two float32 is exact in float64; the float64 sum is
    rounded to odd (its TwoSum error decides the last bit), and rounding to
    odd at 53 bits then to nearest at 24 bits is a correct rounding."""
    p = float(f32(a)) * float(f32(b))
    c = float(f32(c))
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if err != 0.0 and math.isfinite(s):
        bits = int(np.float64(s).view(np.int64))
        if bits & 1 == 0:
            bits += 1 if (err > 0) == (s > 0) else -1
            s = float(np.int64(bits).view(np.float64))
    return f32(s)


def fma_f32_torch(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                  ) -> torch.Tensor:
    """Correctly rounded float32 a * b + c, elementwise with broadcasting:
    `fma_f32` on tensors (exact float64 product, float64 sum rounded to odd,
    then to float32), on the tensors' device."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    fix = (err != 0) & torch.isfinite(s) & ((bits & 1) == 0)
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


def xla_cpu_logf(x) -> np.float32:
    """log(x) of a float32 x, bit for bit as XLA:CPU's float32 log."""
    x = f32(x)
    if math.isnan(x) or x < 0:
        return f32(np.nan)
    if x == 0:
        return f32(-np.inf)
    if math.isinf(x):
        return f32(np.inf)
    x = max(x, _MIN_NORMAL)
    bits = x.view(np.uint32)
    # x = m * 2^e with m in [0.5, 1); then m in [sqrt(1/2), sqrt(2)) - 1
    e = f32(int(bits >> np.uint32(23)) - 127) + f32(1.0)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(f32)
    small = m < _SQRTHF
    tmp = m if small else f32(0.0)
    m = m - f32(1.0)
    e = e - (f32(1.0) if small else f32(0.0))
    m = m + tmp
    x2 = m * m
    x3 = x2 * m
    y = fma_f32(m, _P[0], _P[1])
    y1 = fma_f32(m, _P[3], _P[4])
    y2 = fma_f32(m, _P[6], _P[7])
    y = fma_f32(y, m, _P[2])
    y1 = fma_f32(y1, m, _P[5])
    y2 = fma_f32(y2, m, _P[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, _Q1 * e)       # y * x^3 + q1 * e, contracted
    r = m - x2 * f32(0.5)
    r = r + y
    return fma_f32(_Q2, e, r)         # r + q2 * e, contracted
