"""threefry2x32 and the `jax.random` key operations the engine uses, in torch.

Reproduces, bit for bit, jax 0.9.0's threefry PRNG with
`jax_threefry_partitionable=True` (the reference's configuration):

  * `prng_key(seed)`        == `jax.random.PRNGKey(seed)`: (seed >> 32,
                               seed & 0xFFFFFFFF);
  * `fold_in(key, data)`    == `jax.random.fold_in`: threefry2x32(key,
                               (0, data));
  * `random_bits(key, shape)` == `jax.random.bits(key, shape, uint32)`: the
                               hash of the row-major counter (hi, lo) words,
                               returned as bits1 ^ bits2;
  * `split(key, num)`       == `jax.random.split`: key i is the hash of the
                               counter (0, i), which is `fold_in(key, i)`;
  * `uniform(key, shape)`   == `jax.random.uniform(key, shape)` (float32 in
                               [0, 1)): the top 23 bits as the mantissa of a
                               float in [1, 2), minus 1;
  * `bernoulli(key, p, shape)` == `jax.random.bernoulli`: uniform < p.

torch has little uint32 arithmetic, so 32-bit words are carried in int64
tensors with values in [0, 2^32) and every add is masked. A key is a (..., 2)
int64 tensor of such words. No torch RNG is used anywhere in the port: all
randomness derives from these keys.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def _rounds(x0, x1, rots):
    for r in rots:
        x0 = (x0 + x1) & MASK
        x1 = _rotl(x1, r) ^ x0
    return x0, x1


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the key
    (k0, k1). All arguments are broadcastable int64 tensors of 32-bit words;
    returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        x0, x1 = _rounds(x0, x1, _ROT[i % 2])
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device: Union[str, torch.device] = "cpu"
             ) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` as a (2,) int64 tensor of 32-bit words."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return torch.tensor([(seed >> 32) & MASK, seed & MASK],
                        dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`; `data` is an int or an int64 tensor of
    32-bit words broadcast against the key's leading axes."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint32)` for one (2,) key, as int64 words.
    `key` may carry leading axes (..., 2): the draw is then batched over them
    like `jax.vmap`, giving (..., *shape)."""
    size = 1
    for d in shape:
        size *= int(d)
    idx = torch.arange(size, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k0 = key[..., 0].reshape(*lead, 1)
    k1 = key[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & MASK)
    return (y0 ^ y1).reshape(*lead, *shape)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)` for one (2,) key: a (num, 2) int64 tensor
    of new keys."""
    return fold_in(key.expand(num, 2),
                   torch.arange(num, dtype=torch.int64, device=key.device))


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.uniform(key, shape)`: float32 in [0, 1)."""
    mantissa = (random_bits(key, shape) >> 9) | 0x3F800000
    return mantissa.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int]
              ) -> torch.Tensor:
    """`jax.random.bernoulli(key, p, shape)` for a float p: a bool tensor,
    True with probability p (p is rounded to float32, as in jax)."""
    return uniform(key, shape) < torch.tensor(p, dtype=torch.float32,
                                              device=key.device)
