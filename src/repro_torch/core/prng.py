"""jax 0.9's default PRNG, Threefry-2x32 in its partitionable form, as
plain integer ops: the reference's sampling streams drawn in the port.

A key is two uint32 words. Here a key is held as int64 values below
2^32 — a ``[..., 2]`` tensor on any device, or a ``(hi, lo)`` pair of
Python ints on the host — and every sum is taken mod 2^32. The hash
(:func:`threefry2x32`) is written with operators alone, so the same code
runs on ints, numpy int64 arrays and torch int64 tensors.

What each function is in ``jax/_src/prng.py`` and ``jax/_src/random.py``
(``jax_threefry_partitionable = True``, jax 0.9's default):

* :func:`prng_key` — ``PRNGKey(seed)``: the seed as int32 (x32 mode),
  the words ``(0, seed mod 2^32)``;
* :func:`fold_in` — ``threefry_2x32(key, [0, data])``;
* :func:`split` — ``_threefry_split_foldlike``: the hash of the key over
  the counts ``(0, i)``, i = 0 … num − 1, one new key per count;
* :func:`random_bits` — ``_threefry_random_bits_partitionable`` at 32
  bits: the two words of the hash over the 64-bit iota of the shape,
  xor-ed;
* :func:`uniform` / :func:`gumbel` / :func:`categorical` — ``_uniform``
  (the mantissa trick), ``_gumbel`` (mode "low") and ``categorical``
  with replacement (the Gumbel-max trick over the last axis) in
  float32, as the reference's ``sample_tokens`` calls it (its logits
  over the f32 temperatures are float32).

The functions on tensors take a batch of keys ``[..., 2]``: key b draws
its own ``shape``, as ``jax.vmap`` of the jax function over the keys.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & MASK32) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the count words ``(x1,
    x2)`` under the key ``(k1, k2)``: ``_threefry2x32_lowering``
    unrolled. Arguments are values below 2^32 (ints, int64 arrays or
    tensors, broadcast together); returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x1, x2


# --------------------------------------------------------------------------
# host keys: (hi, lo) pairs of Python ints
# --------------------------------------------------------------------------


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` with x64 off: the seed cut to int32,
    whose logical shift by 32 is 0."""
    return 0, int(seed) & MASK32


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``, ``data`` taken as uint32."""
    return threefry2x32(key[0], key[1], 0, int(data) & MASK32)


def split(key: Key, num: int = 2) -> Tuple[Key, ...]:
    """``jax.random.split(key, num)``: new key i is the hash of the count
    ``(0, i)``."""
    return tuple(threefry2x32(key[0], key[1], 0, i) for i in range(num))


def advance(key: Key, n: int) -> Key:
    """The key after ``n`` samples: ``split(key)[0]`` n times (the
    reference's ``_advance_key``)."""
    for _ in range(n):
        key = threefry2x32(key[0], key[1], 0, 0)
    return key


def request_key(base: Key, uid: int, n_sampled: int) -> Key:
    """A request's key after ``n_sampled`` samples: the reference's
    ``_replayed_key``, ``split``ⁿ``(fold_in(base, uid))[0]``."""
    return advance(fold_in(base, uid), n_sampled)


def split_keys(keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``vmap(split)`` over host keys ``[S, 2]`` (int64): ``(kept,
    drawn)``, the ``[0]`` and ``[1]`` of each key's split."""
    k1, k2 = keys[:, 0], keys[:, 1]
    kept = np.stack(threefry2x32(k1, k2, 0, 0), axis=-1)
    drawn = np.stack(threefry2x32(k1, k2, 0, 1), axis=-1)
    return kept, drawn


# --------------------------------------------------------------------------
# draws: batched keys [..., 2] as int64 tensors, on the keys' device
# --------------------------------------------------------------------------


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) of each key of ``keys
    [..., 2]``: ``[..., *shape]`` int64 values below 2^32. The counts
    are the 64-bit iota of ``shape`` as (hi, lo) words."""
    shape = tuple(int(s) for s in shape)
    numel = int(np.prod(shape)) if shape else 1
    iota = torch.arange(numel, dtype=torch.int64, device=keys.device)
    lead = keys.shape[:-1]
    k1 = keys[..., 0].reshape(*lead, 1)
    k2 = keys[..., 1].reshape(*lead, 1)
    b1, b2 = threefry2x32(k1, k2, iota >> 32, iota & MASK32)
    return (b1 ^ b2).reshape(*lead, *shape)


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (``_uniform``): the top 23 of
    the random bits as the mantissa under the exponent of 1.0, less 1,
    scaled to ``[minval, maxval)`` and floored at ``minval``."""
    bits = (random_bits(keys, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0   # < 2^31
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=keys.device) - lo
    if float(span) == 1.0:          # an exact product: one rounding
        scaled = floats + lo
    else:
        # XLA contracts ``floats * span + lo`` into one fused multiply-add:
        # the product and the sum are exact in f64, rounded once
        scaled = (floats.double() * span.double()
                  + lo.double()).to(torch.float32)
    return torch.maximum(lo, scaled)


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32 and its default "low"
    mode: ``-log(-log(u))``, u uniform on ``[tiny, 1)``."""
    u = uniform(keys, shape, minval=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.vmap(jax.random.categorical)(keys, logits)`` over the last
    axis of float32 ``logits``: key b's Gumbel noise added to
    ``logits[b]``, then the first index of the largest (int64 ``[...]``)."""
    return torch.argmax(gumbel(keys, logits.shape[-1:]) + logits, dim=-1)
