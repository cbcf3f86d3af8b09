"""The JAX package's default random stream (Threefry-2x32), in torch.

``reservoir_insert`` draws its Gumbel priorities as
``jax.random.gumbel(fold_in(PRNGKey(seed), seen), (b,), float32)``; this
module reproduces that draw, so that a port reservoir admits the rows the
JAX package's admits. It follows ``jax/_src/prng.py`` as configured by
default (``jax_default_prng_impl="threefry2x32"``,
``jax_threefry_partitionable=True``):

* ``PRNGKey(seed)`` is the pair ``(seed >> 32, seed & 0xffffffff)``;
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)`` under
  ``key``;
* the bits of draw ``i`` of ``(b,)`` are the two words of the hash of
  ``(i >> 32, i & 0xffffffff)`` XOR-ed together;
* a uniform float32 in ``[tiny, 1)`` keeps the top 23 bits as a mantissa
  of ``[1, 2)``, minus 1 (``jax.random._uniform``);
* the Gumbel draw is ``-log(-log(u))`` (``_gumbel``'s default ``"low"``
  form).

There is no uint32 arithmetic in torch, so every word is an int64 in
``[0, 2**32)``, masked after each addition and shift. The uniform bits are
the JAX package's bit for bit. Each of the two logs is taken in float64
and rounded once to float32 (correctly rounded): XLA's float32 ``log`` on
the CPU is an ulp off that on 14% of the inner logs, and torch's differs
again, so this is what makes the card and the CPU give the same
priorities. They are within 2 ulp of the JAX package's, counted at
``max(|g|, 1)`` (where ``g`` crosses 0 a relative ulp means nothing);
ROADMAP.md, C, "Properties". The counter can be a
tensor on the card, so a draw reads nothing back and can be captured in a
CUDA graph.
"""
from typing import Any, Tuple, Union

import torch

Tensor = torch.Tensor
Word = Union[int, Tensor]

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal, the uniform draw's lower end
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: Tensor, d: int) -> Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(key: Tuple[Word, Word], x1: Word, x2: Word) -> Tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x1, x2)``
    under ``key``; words are int64 tensors (or ints) in ``[0, 2**32)``."""
    k1, k2 = key
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = torch.as_tensor(x1 + ks[0]) & _MASK
    x2 = torch.as_tensor(x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as its two words."""
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(key: Tuple[Word, Word], data: Any) -> Tuple[Tensor, Tensor]:
    """``jax.random.fold_in(key, data)``: ``data`` (an int or an integer
    tensor, taken modulo 2**32) hashed under ``key``."""
    if isinstance(data, Tensor):
        data = data.to(torch.int64) & _MASK
    else:
        data = torch.tensor(int(data) & _MASK, dtype=torch.int64)
    return threefry2x32(key, torch.zeros_like(data), data)


def random_bits(key: Tuple[Word, Word], n: int, device: Any = None) -> Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as int64 words."""
    if device is None:
        device = key[0].device if isinstance(key[0], Tensor) else torch.device("cpu")
    counts = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = threefry2x32(key, counts >> 32, counts & _MASK)
    return hi ^ lo


def uniform(key: Tuple[Word, Word], n: int, device: Any = None) -> Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``,
    bit for bit."""
    bits = random_bits(key, n, device)
    floats = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)) - 1.0
    lo = torch.full((), _TINY, dtype=torch.float32, device=floats.device)
    # (maxval - minval) rounds to 1 in float32
    return torch.maximum(lo, floats * (1.0 - _TINY) + lo)


def gumbel(key: Tuple[Word, Word], n: int, device: Any = None) -> Tensor:
    """``jax.random.gumbel(key, (n,), float32)`` (its ``"low"`` form), each
    log correctly rounded to float32 (taken in float64, rounded once)."""
    inner = torch.log(uniform(key, n, device).to(torch.float64)).to(torch.float32)
    return (-torch.log(-inner.to(torch.float64))).to(torch.float32)
