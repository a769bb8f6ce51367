"""Counter-based random numbers: threefry2x32, the generator behind jax.random.

Bit-for-bit with jax.random (jax_threefry_partitionable=True, the default)
for PRNGKey, fold_in, split and float32 uniform, so one key drives both
renderers to the same samples. A key is a pair of uint32 words held as
Python ints; key derivation runs on the host, and only `uniform` touches
tensors. Tensor arithmetic is int64 masked to 32 bits, because torch's
uint32 support is incomplete (on CUDA especially).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclass(frozen=True)
class Key:
    """A threefry key: two uint32 words (jax.random.key_data order)."""
    k1: int
    k2: int


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def _threefry2x32(k1: int, k2: int, x1, x2):
    """The 20-round threefry2x32 block on counters (x1, x2).

    x1, x2 are Python ints or int64 tensors holding uint32 values."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def PRNGKey(seed: int) -> Key:
    """jax.random.PRNGKey(seed) for a 32-bit seed."""
    return Key((int(seed) >> 32) & _M32 if int(seed) >= 0 else 0,
               int(seed) & _M32)


def fold_in(key: Key, data: int) -> Key:
    """jax.random.fold_in: threefry of the counter pair (0, data)."""
    return Key(*_threefry2x32(key.k1, key.k2, 0, int(data) & _M32))


def split(key: Key, num: int = 2) -> tuple[Key, ...]:
    """jax.random.split: key i is threefry of the counter pair (0, i)."""
    return tuple(Key(*_threefry2x32(key.k1, key.k2, 0, i))
                 for i in range(num))


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """uint32 bits as int64, one threefry block per flat index: the two
    output words XORed (jax's partitionable random_bits)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = _threefry2x32(key.k1, key.k2, torch.zeros_like(idx), idx)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: Key, shape, device=None) -> torch.Tensor:
    """float32 uniforms in [0, 1): the top 23 bits as a mantissa in [1, 2),
    minus one (jax.random.uniform's construction)."""
    bits = (random_bits(key, shape, device) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0
