"""The reference's PRNG — ``jax.random`` with its default threefry2x32
implementation — in numpy, for the two paths of the port that must draw
what the reference draws:

  * the vision models' initial parameters: ``models/vision.init_vision(
    cfg, PRNGKey(seed))`` walks the reference's key tree, so the training
    CLI repeats the reference's CLI at the same seed;
  * ``int8_sr``'s rounding noise: the per-leaf keys
    ``fold_in(fold_in(PRNGKey(seed), t), leaf)`` that its kernel
    (``kernels/int8_sr``) expands into uniforms on the card.

It is a copy because the port imports no JAX. What it holds, against
``jax.random`` on the same key: ``PRNGKey``, ``fold_in``, ``split``,
``random_bits`` and ``uniform`` bit for bit, in either counter layout;
``normal`` to within a few f32 ulp (it runs XLA's f32 ``erf_inv``
polynomial on numpy's f32 ``log1p``, where XLA has its own ``log1p``).

Two counter layouts exist, chosen in JAX by the flag
``jax_threefry_partitionable``:

  partitionable (``PARTITIONABLE = True``, JAX's default since 0.5)
      element n of a draw of ``shape`` (n its row-major index) hashes the
      counter pair (n >> 32, n & 0xffffffff), and its 32 bits are the two
      output words XORed; ``split(key, k)[i]`` hashes (0, i), which is
      ``fold_in(key, i)``;
  split-counter (``PARTITIONABLE = False``, JAX 0.4)
      a draw of S elements hashes the pairs (i, h + i) for i < h =
      ceil(S / 2) (the counter past S - 1 is 0), and element n is output
      word 0 of pair n for n < h, word 1 of pair n - h otherwise;
      ``split`` draws 2k such words and pairs them up.

``PARTITIONABLE`` is the layout of the JAX the reference runs with; the
kernels take it as an argument.
"""
from __future__ import annotations

import math

import numpy as np

PARTITIONABLE = True

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's f32 erf_inv (Giles' polynomial), for w < 5 and w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al., SC 2011), as
    ``jax.random``'s: the key's two words and the counter words ``x0``,
    ``x1`` (uint32 arrays of one shape) -> the two output words."""
    k0, k1 = (np.uint32(int(w)) for w in np.asarray(key, np.uint32))
    ks = (k0, k1, np.uint32(int(k0) ^ int(k1) ^ _PARITY))
    x = [np.array(x0, np.uint32, copy=True), np.array(x1, np.uint32,
                                                      copy=True)]
    with np.errstate(over="ignore"):
        x[0] += ks[0]
        x[1] += ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] += x[1]
                x[1] = (x[1] << np.uint32(r)) | (x[1] >> np.uint32(32 - r))
                x[1] ^= x[0]
            x[0] += ks[(i + 1) % 3]
            x[1] += ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (32-bit JAX: the seed is an int32)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside int32, which the "
                         "reference (no x64) cannot take")
    return np.array([0, seed & _MASK], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    pair (0, data)."""
    data = int(data)
    if not 0 <= data <= _MASK:
        raise ValueError(f"fold_in data {data} is not a uint32")
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32),
                          np.array([data], np.uint32))
    return np.array([y0[0], y1[0]], np.uint32)


def fold_in_many(key, data) -> np.ndarray:
    """(L, 2) keys: ``fold_in(key, d)`` for each d of ``data``, in one
    vectorized hash."""
    data = np.asarray(data, np.uint32)
    y0, y1 = threefry2x32(key, np.zeros_like(data), data)
    return np.stack([y0, y1], axis=-1)


def _counters(size: int, partitionable: bool):
    """Counter words of a draw of ``size`` elements in either layout."""
    if partitionable:
        n = np.arange(size, dtype=np.uint64)
        return ((n >> np.uint64(32)).astype(np.uint32),
                (n & np.uint64(_MASK)).astype(np.uint32))
    if size >= _MASK:
        raise ValueError("split-counter draws of 2**32 - 1 elements or more "
                         "are not implemented")
    h = -(-size // 2)
    x0 = np.arange(h, dtype=np.uint32)
    x1 = np.arange(h, 2 * h, dtype=np.uint32)
    if size % 2:
        x1[-1] = 0                   # the padding counter
    return x0, x1


def split(key, num: int = 2, partitionable: bool = None) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    part = PARTITIONABLE if partitionable is None else partitionable
    if part:
        return fold_in_many(key, np.arange(num))
    y0, y1 = threefry2x32(key, *_counters(2 * num, False))
    return np.concatenate([y0, y1]).reshape(num, 2)


def random_bits(key, shape, partitionable: bool = None) -> np.ndarray:
    """``jax.random.bits(key, shape)`` in uint32."""
    part = PARTITIONABLE if partitionable is None else partitionable
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    y0, y1 = threefry2x32(key, *_counters(size, part))
    bits = y0 ^ y1 if part else np.concatenate([y0, y1])[:size]
    return bits.reshape(shape)


def bits_to_unit(bits) -> np.ndarray:
    """32 random bits -> f32 in [0, 1): the high 23 bits as the mantissa
    of a float in [1, 2), less 1 (``jax.random.uniform``'s construction)."""
    bits = np.asarray(bits, np.uint32)
    one = np.uint32(0x3F800000)
    return (((bits >> np.uint32(9)) | one).view(np.float32)
            - np.float32(1.0))


def uniform(key, shape, minval=0.0, maxval=1.0,
            partitionable: bool = None) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = bits_to_unit(random_bits(key, shape, partitionable))
    return np.maximum(lo, floats * (hi - lo) + lo)


def erfinv_f32(x) -> np.ndarray:
    """XLA's f32 ``erf_inv``: Giles' single-precision polynomial in
    w = -log1p(-x^2), with erfinv(+-1) = +-inf."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5),
                     np.sqrt(w) - np.float32(3.0)).astype(np.float32)
        p = np.where(lt, np.float32(_ERFINV_LT5[0]),
                     np.float32(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = np.where(lt, np.float32(a), np.float32(b)) + p * w
        out = p * x
        return np.where(np.abs(x) == np.float32(1.0),
                        x * np.float32(np.inf), out).astype(np.float32)


def normal(key, shape, partitionable: bool = None) -> np.ndarray:
    """``jax.random.normal(key, shape)`` in f32: sqrt(2)·erfinv(u) with u
    uniform on [nextafter(-1, 0), 1)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0, partitionable)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
