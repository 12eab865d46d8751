"""Threefry-2x32 counter-based random numbers, bit for bit as the reference
draws them.

JT65's stochastic Chase erasure patterns come from
``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(17), seed),
(c, n_sto, n))`` in the reference's ``cwsl_digi_tpu/modes/rs_device.py``
(``rs_chase_program``, :254-255); near the decode threshold a different
pattern set gives a different decode list, so the port reproduces those
draws exactly:

- a key is a pair of uint32 words; :func:`prng_key` of a 32-bit seed is
  ``(0, seed)``;
- :func:`fold_in` hashes the pair ``(0, data)`` under the key, and the two
  output words are the new key;
- :func:`uniform` hashes the 64-bit row-major index of every element as the
  counter pair ``(index >> 32, index & 0xFFFFFFFF)`` (the "partitionable"
  counter layout), XORs the two output words, keeps the top 23 bits as the
  mantissa of a float in [1, 2) and subtracts 1.

The words live in int64 tensors masked to 32 bits (``torch.uint32`` lacks
most operations on CUDA), so the same code runs on any device.  This is
the plain version: on a card the Chase program's ``chase_erasures`` kernel
(``csrc/chase.cu``) hashes the same counters in uint32 arithmetic.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
# Threefry-2x32 rotation schedule (20 rounds in five groups of four) and
# key-schedule parity constant
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & MASK


def threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function of key ``(k1, k2)`` over counter
    words ``x0, x1`` (uint32 values in int64 tensors; the key words may be
    0-dim tensors)."""
    ks = (k1, k2, k1 ^ k2 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device: torch.device | str = "cpu"
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The key of a 32-bit integer seed: ``(0, seed mod 2**32)``."""
    if not -2**31 <= seed < 2**31:
        raise ValueError("seed must fit in 32 bits")
    return (torch.zeros((), dtype=torch.int64, device=device),
            torch.tensor(seed & MASK, dtype=torch.int64, device=device))


def fold_in(key: tuple[torch.Tensor, torch.Tensor], data
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """A new key from ``key`` and a 32-bit ``data`` word (an int or a 0-dim
    integer tensor, taken mod 2**32)."""
    k1, k2 = key
    d = torch.as_tensor(data, dtype=torch.int64, device=k1.device) & MASK
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(d), d)
    return y0, y1


def random_bits(key: tuple[torch.Tensor, torch.Tensor], shape: tuple,
                offset: int = 0) -> torch.Tensor:
    """32 random bits per element of ``shape`` (int64 tensor), elements
    counted from the row-major index ``offset`` on (a slice of a larger
    draw starting at that element)."""
    k1, k2 = key
    idx = offset + torch.arange(math.prod(shape), dtype=torch.int64,
                                device=k1.device)
    b0, b1 = threefry2x32(k1, k2, idx >> 32, idx & MASK)
    return (b0 ^ b1).reshape(shape)


def uniform(key: tuple[torch.Tensor, torch.Tensor], shape: tuple,
            offset: int = 0) -> torch.Tensor:
    """float32 uniforms in [0, 1) of ``shape``: the top 23 random bits as
    the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape, offset) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
