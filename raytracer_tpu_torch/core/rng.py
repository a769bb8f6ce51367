"""Counter-based random numbers: threefry2x32, the generator behind jax.random.

Bit-for-bit with jax.random (jax_threefry_partitionable=True, the default)
for PRNGKey, fold_in, split, float32 uniform and int32 randint, so one
key drives both renderers to the same samples. A key is a pair of uint32
words held as Python ints, and key derivation runs on the host. A batch
of keys holds its words as int64 tensors of one shape: `fold_in` of a key
with a tensor of data makes one (jax.vmap(fold_in, (None, 0))), and
`uniform` / `random_bits` of such keys draw `shape` numbers per key, into
a tensor of shape keys + shape.

On the card every draw, and fold_in of a tensor, is one launch of the
threefry kernel (ops/cuda/rng_kernel, csrc/threefry.cu), which raises
rather than fall back. On the CPU the plain version runs: the block as
int64 tensor arithmetic masked to 32 bits (torch's uint32 support is
incomplete), which is the kernel's reference. Other devices raise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..ops.cuda import rng_kernel

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


@dataclass(frozen=True)
class Key:
    """A threefry key: two uint32 words (jax.random.key_data order), Python
    ints, or int64 tensors of one shape for a batch of keys."""
    k1: int | torch.Tensor
    k2: int | torch.Tensor


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _M32


def _threefry2x32(k1, k2, x1, x2):
    """The 20-round threefry2x32 block on counters (x1, x2).

    Keys and counters are Python ints or int64 tensors holding uint32
    values; tensors broadcast."""
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


def _on_card(device) -> bool:
    """True for a CUDA device (the kernel), False for the CPU (the plain
    version; None is the CPU, torch's default); other devices raise."""
    kind = torch.device('cpu' if device is None else device).type
    if kind not in ('cuda', 'cpu'):
        raise ValueError(f'core/rng: unsupported device {device}')
    return kind == 'cuda'


def _key_device(key: Key, device):
    """A batch of keys draws on its own device, a host key on `device`."""
    return key.k1.device if isinstance(key.k1, torch.Tensor) else device


def plain_fold_in(key: Key, data) -> Key:
    """The plain version of fold_in, on any device."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
    else:
        data = int(data) & _M32
    return Key(*_threefry2x32(key.k1, key.k2, 0, data))


def fold_in(key: Key, data) -> Key:
    """jax.random.fold_in: threefry of the counter pair (0, data). A tensor
    of data gives a batch of keys of its shape."""
    if isinstance(data, torch.Tensor) and _on_card(data.device):
        return Key(*rng_kernel.pair(key.k1, key.k2, data))
    if isinstance(key.k1, torch.Tensor) and _on_card(key.k1.device):
        return Key(*rng_kernel.pair(key.k1, key.k2, torch.full_like(
            key.k1, int(data) & _M32)))
    return plain_fold_in(key, data)


def split(key: Key, num: int = 2) -> tuple[Key, ...]:
    """jax.random.split: key i is threefry of the counter pair (0, i)."""
    return tuple(fold_in(key, i) for i in range(num))


def _counters(shape, segment, axis: int, device) -> torch.Tensor:
    """Each output's counter, int64 (the plain version's): its flat index,
    or with `segment` the index it has in a draw of `segment` along `axis`
    (uniform_segmented), (outer * segment + r % segment) * inner + i for
    the output (outer, r, i) with `inner` elements after the axis. The
    kernel computes the same from the output index."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    if segment is None:
        return idx
    inner = math.prod(shape[axis + 1:])
    q = idx // inner
    return ((q // shape[axis]) * segment + (q % shape[axis]) % segment) \
        * inner + idx % inner


def plain_bits(key: Key, shape, device=None, segment=None,
               axis: int = 0) -> torch.Tensor:
    """The plain version of a draw on any device: uint32 bits as int64,
    keys' shape + shape, with uniform_segmented's `segment` along
    `axis`."""
    k1, k2 = key.k1, key.k2
    batch = ()
    if isinstance(k1, torch.Tensor):
        batch = tuple(k1.shape)
        k1, k2 = k1[..., None], k2[..., None]
    c = _counters(shape, segment, axis, _key_device(key, device))
    b1, b2 = _threefry2x32(k1, k2, torch.zeros_like(c), c)
    return (b1 ^ b2).reshape(batch + tuple(shape))


def plain_uniform(key: Key, shape, device=None, segment=None,
                  axis: int = 0) -> torch.Tensor:
    """The plain version of uniform_segmented: the top 23 bits as a
    mantissa in [1, 2), minus one."""
    bits = (plain_bits(key, shape, device, segment, axis) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def random_bits(key: Key, shape, device=None) -> torch.Tensor:
    """uint32 bits as int64, one threefry block per flat index: the two
    output words XORed (jax's partitionable random_bits). A batch of keys
    draws `shape` per key (on the keys' device) -> keys' shape + shape."""
    device = _key_device(key, device)
    if _on_card(device):
        return rng_kernel.draw(key.k1, key.k2, shape, device, 'bits')
    return plain_bits(key, shape, device)


def uniform(key: Key, shape, device=None) -> torch.Tensor:
    """float32 uniforms in [0, 1): the top 23 bits as a mantissa in [1, 2),
    minus one (jax.random.uniform's construction)."""
    return uniform_segmented(key, shape, None, 0, device)


def uniform_segmented(key: Key, shape, segment=None, axis: int = 0,
                      device=None) -> torch.Tensor:
    """uniform(key, shape) for a batch of wavefronts of `segment` rays laid
    end to end along `axis`: each run of `segment` rows draws what
    uniform(key, shape) with `segment` there draws, as that wavefront would
    alone (each output's counter is its index within its run). segment
    None: one wavefront, uniform(key, shape)."""
    if segment is not None and shape[axis] % segment:
        raise ValueError(f'uniform_segmented: {shape[axis]} rows along axis '
                         f'{axis} are not runs of {segment}')
    device = _key_device(key, device)
    if _on_card(device):
        return rng_kernel.draw(key.k1, key.k2, shape, device, 'uniform',
                               segment, axis)
    return plain_uniform(key, shape, device, segment, axis)


def randint(key: Key, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """jax.random.randint for int32 in [minval, maxval): two rounds of
    32-bit draws from split(key), hi and lo, folded into the span as
    (hi % span) * mult + lo % span, modulo span, with mult = (2**16 %
    span)**2 % span and uint32 wrap-around at each step, as jax computes
    them (for spans above 2**16 the square wraps to 0, so only lo counts)."""
    k1, k2 = split(key)
    hi = random_bits(k1, shape, device)
    lo = random_bits(k2, shape, device)
    span = (int(maxval) - int(minval)) & _M32 if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & _M32) % span
    off = ((((hi % span) * mult) & _M32) + lo % span) & _M32
    return (int(minval) + off % span).to(torch.int32)
