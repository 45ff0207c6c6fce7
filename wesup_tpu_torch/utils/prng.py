"""The parts of ``jax.random`` that the port draws from, in numpy.

The JAX package draws its initial weights and its per-batch augmentation
from threefry keys; the port draws the same bits on the host, so that
``seed=s`` names one run in both packages.  This module follows JAX 0.9.0
with ``jax_threefry_partitionable=True`` (its default since 0.5.0):

- :func:`threefry2x32`, the Threefry-2x32 hash (20 rounds, rotations
  13/15/26/6 and 17/29/16/24, key schedule with 0x1BD11BDA);
- :func:`PRNGKey` (``[0, seed]`` for a 32-bit seed), :func:`split` and
  :func:`fold_in`, which both hash the counter pair ``(0, i)``;
- :func:`random_bits`, the xor of the two hash words of each element's
  flat index (the partitionable layout);
- :func:`uniform`: 23 random mantissa bits under the exponent of 1.0,
  minus 1, then ``* (max - min) + min`` and ``max(min, .)``, all in f32;
  XLA's CPU compiler contracts the multiply-add into one fused
  multiply-add, so :func:`fma32` rounds it once, as it does;
- :func:`bernoulli`: ``uniform(key, shape) < p`` in f32;
- :func:`normal`: ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on
  ``(nextafter(-1, 0), 1)``, and ``erf_inv`` the f32 polynomial of XLA's
  ``chlo.erf_inv`` decomposition (Giles's approximation), on XLA's CPU
  ``log1p``: a Cephes rational function below ``sqrt(2) - 1`` and the
  Cephes ``log`` of ``1 + x`` above, with the multiply-adds fused as the
  CPU compiler fuses them (:func:`log1p`).

Every function takes one key, a (2,) uint32 array, or many, a (..., 2)
array, and then returns one result per key, stacked along the leading
axes (what ``jax.vmap`` of the function over the keys gives).  Uniform,
bernoulli and normal draws are bitwise JAX's on the CPU where the f32
operations here are IEEE's (``sqrt`` and ``/`` correctly rounded).
``tests/test_torch_port_init.py`` and ``tests/test_torch_port_prng.py``
fail if the installed JAX changes its flag or its bits.
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32
_F = np.float32


_M32 = 0xFFFFFFFF


def _rounds(k0, k1, x0, x1, wrap):
    """Threefry-2x32's 20 rounds of ``(x0, x1)`` under ``(k0, k1)``, with
    ``wrap`` reducing a sum or a left shift to 32 bits (the identity on
    uint32 arrays, which wrap by themselves; a mask on Python ints)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = wrap(x0 + ks[0]), wrap(x1 + ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = wrap(x0 + x1)
            x1 = (wrap(x1 << r) | (x1 >> (32 - r))) ^ x0
        x0 = wrap(x0 + ks[(i + 1) % 3])
        x1 = wrap(x1 + ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash of the counter words ``(x0, x1)`` (uint32
    arrays of one shape) under ``key`` (``(..., 2)`` uint32 whose leading
    shape broadcasts against theirs): two uint32 arrays."""
    key = np.asarray(key, np.uint32)
    with np.errstate(over="ignore"):
        return _rounds(key[..., 0], key[..., 1], np.asarray(x0, np.uint32),
                       np.asarray(x1, np.uint32), lambda v: v)


def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` for a seed that fits in 32 bits."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _keys(key) -> np.ndarray:
    key = np.asarray(key)
    if key.shape[-1:] != (2,) or key.dtype.kind not in "ui":
        raise TypeError(f"a key is (..., 2) uint32, as PRNGKey gives; got "
                        f"{key.dtype} {key.shape}")
    return key.astype(np.uint32, copy=False)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``key.shape[:-1] + (num, 2)``."""
    key = _keys(key)
    i = np.arange(num, dtype=np.uint32)
    b0, b1 = threefry2x32(key[..., None, :], np.zeros_like(i), i)
    return np.stack([b0, b1], axis=-1)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)``; ``data`` is an int or an array
    that broadcasts against ``key.shape[:-1]``.  One key and one int (a
    trainer's batch-key chain) hash as Python ints, in a tenth of the
    time numpy's calls take on one element."""
    key = _keys(key)
    if key.shape == (2,) and isinstance(data, (int, np.integer)):
        return np.array(_rounds(int(key[0]), int(key[1]), 0,
                                int(data) & _M32, lambda v: v & _M32),
                        np.uint32)
    d = np.asarray(data, np.int64).astype(np.uint32)
    b0, b1 = threefry2x32(key, np.zeros_like(d), d)
    return np.stack(np.broadcast_arrays(b0, b1), axis=-1)


def random_bits(key, shape=()) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``:
    ``key.shape[:-1] + shape``."""
    key = _keys(key)
    shape = tuple(shape)
    i = np.arange(int(np.prod(shape)), dtype=np.uint32)
    b0, b1 = threefry2x32(key[..., None, :], np.zeros_like(i), i)
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def fma32(a, b, c) -> np.ndarray:
    """``a * b + c`` of f32 operands, rounded once to f32 (a fused
    multiply-add), for results in the normal f32 range.  The product is
    exact in f64, so the f64 sum ``s`` is the only rounding before the
    last; the two differ from one rounding only where ``s`` lies on the
    midpoint of two f32 values (its 29 low mantissa bits 1000...0), and
    there TwoSum's error term picks the side."""
    a, b, c = (np.asarray(v, _F) for v in (a, b, c))
    s = np.multiply(a, b, dtype=np.float64)
    s += c
    r = s.astype(_F)
    tie = (s.view(np.uint64) & np.uint64(0x1FFFFFFF)) == np.uint64(0x10000000)
    if tie.any():
        a, b, c, r = np.broadcast_arrays(a, b, c, r)
        r = r.copy()
        p = a[tie].astype(np.float64) * b[tie]
        cc = c[tie].astype(np.float64)
        st = s[tie]
        bb = st - p
        e = (p - (st - bb)) + (cc - bb)
        rt = r[tie]
        rt = np.where((e > 0) & (rt < st), np.nextafter(rt, _F(np.inf)), rt)
        rt = np.where((e < 0) & (rt > st), np.nextafter(rt, _F(-np.inf)), rt)
        r[tie] = rt
    return r


def uniform(key, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``;
    ``minval`` and ``maxval`` may be arrays that broadcast against the
    result (one limit per key: what a vmap over the limits gives)."""
    lo, hi = np.asarray(minval, _F), np.asarray(maxval, _F)
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, fma32(floats, hi - lo, lo))


def bernoulli(key, p, shape=()) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` in f32."""
    return uniform(key, shape) < np.asarray(p, _F)


_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553540365689E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)


def _horner(x, coeffs):
    p = np.zeros_like(x)
    for c in coeffs:
        p = fma32(p, x, _F(c))
    return p


def _log(v: np.ndarray) -> np.ndarray:
    """XLA's CPU f32 ``log`` of positive normal ``v`` (Cephes: mantissa in
    [sqrt(1/2), sqrt(2)), a degree-8 polynomial in three Horner pieces,
    the exponent added back as ``e * (q2 + q1)``)."""
    bits = np.maximum(v, _F(1.17549435e-38)).astype(_F).view(np.uint32)
    m = ((bits & _U32(0x807FFFFF)) | _U32(0x3F000000)).view(_F)
    e = ((bits >> _U32(23)).astype(np.int32) - 0x7E).astype(_F)
    small = m < _F(0.707106781186547524)
    x = (m - _F(1)) + np.where(small, m, _F(0))
    e = e - np.where(small, _F(1), _F(0))
    x2 = x * x
    x3 = x2 * x
    p = _LOG_P
    y = fma32(fma32(_F(p[0]), x, _F(p[1])), x, _F(p[2]))
    y1 = fma32(fma32(_F(p[3]), x, _F(p[4])), x, _F(p[5]))
    y2 = fma32(fma32(_F(p[6]), x, _F(p[7])), x, _F(p[8]))
    y = fma32(fma32(y, x3, y1), x3, y2)
    y = fma32(y, x3, e * _F(-2.12194440e-4))
    x = fma32(x2, _F(-0.5), x) + y
    return fma32(e, _F(0.693359375), x)


def log1p(x: np.ndarray) -> np.ndarray:
    """XLA's CPU f32 ``log1p``."""
    x = np.asarray(x, _F)
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    r = x + fma32(_F(-0.5), x2, (x * x2) * r)
    big = np.abs(x) >= _F(0.41421356237309504880)
    if big.any():
        r[big] = _log(x[big] + _F(1))
    return r


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv`` (``chlo.erf_inv``): a degree-8 polynomial in
    ``w - 2.5`` where ``w = -log1p(-x * x) < 5``, else in
    ``sqrt(w) - 3``."""
    x = np.asarray(x, _F)
    w = -log1p(x * -x)
    out = np.empty_like(x)
    lt = w < _F(5.0)
    for sel, coeffs, shift in ((lt, _ERFINV_LT5, None),
                               (~lt, _ERFINV_GE5, _F(3.0))):
        if not sel.any():
            continue
        ws = w[sel]
        ws = ws - _F(2.5) if shift is None else np.sqrt(ws) - shift
        p = np.full_like(ws, _F(coeffs[0]))
        for c in coeffs[1:]:
            p = fma32(p, ws, _F(c))
        out[sel] = p * x[sel]
    edge = np.abs(x) == 1
    out[edge] = x[edge] * _F(np.inf)
    return out


def normal(key, shape=(), scale=1.0) -> np.ndarray:
    """``jax.random.normal(key, shape, float32) * scale`` for an f32
    constant ``scale``, as XLA compiles it: the constant folded into the
    ``sqrt(2)`` of the draw, ``erf_inv(u) * (sqrt(2) * scale)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0), dtype=np.float32)
    u = uniform(key, shape, lo, np.float32(1.0))
    return erf_inv(u) * (np.float32(np.sqrt(2)) * np.float32(scale))
