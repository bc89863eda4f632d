"""GF(2) CSS encoder (port of `qldpcsim_tpu/channel/encoder.py`).

A CSS stabilizer state is tracked in the binary symplectic picture as a
codeword frame (x | z): the x-component in rowspace(Hx) + span(Lx), the
z-component likewise with the Z-type generators. Encoding a maximally mixed
logical state corresponds to sampling uniform logical bits and a uniform
stabilizer coset. The frame is annihilated by both check matrices, so it
never affects syndromes: `ShotPipeline(validate_encoding=True)` runs the
full encode -> corrupt -> extract pipeline to show exactly that.

The four bernoulli(0.5) draws are the reference's (`jax.random.split(key,
4)`, then one draw each), reproduced bit for bit; the frame products are
plain float32 matrix products of 0/1 entries, which count exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from qldpcsim_torch import gf2
from qldpcsim_torch.utils.threefry import bernoulli, split


@dataclasses.dataclass(frozen=True)
class CSSEncoder:
    """Samples random codeword frames of a CSS code."""

    n: int
    k: int
    Gx: np.ndarray  # (rx, n) row basis of Hx  (X-type stabilizer generators)
    Gz: np.ndarray  # (rz, n) row basis of Hz
    Lx: np.ndarray  # (k, n) logical X ops
    Lz: np.ndarray  # (k, n) logical Z ops

    @staticmethod
    def build(Hx: np.ndarray, Hz: np.ndarray) -> "CSSEncoder":
        Hx = np.asarray(Hx) % 2
        Hz = np.asarray(Hz) % 2
        Lx, Lz = gf2.logical_ops(Hx, Hz)
        return CSSEncoder(
            n=Hx.shape[1],
            k=Lx.shape[0],
            Gx=gf2.row_basis(Hx),
            Gz=gf2.row_basis(Hz),
            Lx=Lx,
            Lz=Lz,
        )

    def encode(self, key: torch.Tensor, batch: int):
        """Sample `batch` random codeword frames from one (2,) key, on the
        key's device.

        Returns (frame_x, frame_z): (batch, n) int8 symplectic components
        with Hz @ frame_x == 0 and Hx @ frame_z == 0 (mod 2), uniform over
        logical states and stabilizer cosets.
        """
        f32 = torch.float32
        dev = key.device
        kx, kz, ka, kb = split(key, 4)

        def draw(k, G):
            bits = bernoulli(k, 0.5, (batch, G.shape[0])).to(f32)
            return bits @ torch.as_tensor(np.asarray(G), dtype=f32,
                                          device=dev)

        frame_x = torch.remainder(draw(kx, self.Lx) + draw(ka, self.Gx), 2.0)
        frame_z = torch.remainder(draw(kz, self.Lz) + draw(kb, self.Gz), 2.0)
        return frame_x.to(torch.int8), frame_z.to(torch.int8)
