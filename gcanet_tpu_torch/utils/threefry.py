"""``jax.random``'s stream on the host, in numpy: the same seed gives the
same bits and the same floats as the JAX package's draws, with no JAX.

JAX's default generator is Threefry-2x32 (20 rounds) in its
"partitionable" form (``jax_threefry_partitionable``, the default since
JAX 0.5): an array's bits are the hash of its row-major element index as a
64-bit counter, split in two 32-bit words.  A key is two ``uint32`` words.
The functions follow ``jax/_src/prng.py`` (``threefry_seed``,
``threefry_2x32``, ``_threefry_split_foldlike``, ``_threefry_fold_in``,
``_threefry_random_bits_partitionable``) and ``jax/_src/random.py``
(``_uniform``, ``_normal_real``, ``_truncated_normal``), in float32 as JAX
computes them without x64.

The floats follow XLA's float32 code on the CPU step by step: its fused
multiply-adds (one rounding each; ``_fma``), its ``log`` and ``log1p``
(after the Cephes library) and its inverse error function (M. Giles'
polynomials).  So the bits, keys, uniforms, normals and truncated normals
equal what JAX gives on the CPU bit for bit (``tests/test_torch_weights.py``
holds them to it, the normals within 4 units in the last place as their
contract); a TPU evaluates the float functions with its own last bits.
"""

from __future__ import annotations

import math

import numpy as np

Key = np.ndarray            # shape (2,), uint32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2 = np.float32(math.sqrt(2.0))


def threefry2x32(key: Key, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash of the counter pairs ``(x1, x2)`` under
    ``key`` (``prng.py::_threefry2x32_lowering``)."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        a = np.add(x1, ks[0], dtype=np.uint32)
        b = np.add(x2, ks[1], dtype=np.uint32)
        high = np.empty_like(b)
        for i in range(5):
            for r in _ROTATIONS[i % 2]:            # a += b; b = rotl(b, r) ^ a, in place
                a += b
                np.left_shift(b, np.uint32(r), out=high)
                b >>= np.uint32(32 - r)
                b |= high
                b ^= a
            a += ks[(i + 1) % 3]
            b += ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)``: without x64 the seed is taken as a
    32-bit integer, so the high word is 0."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)``: the hash of the pair ``(0, data)``."""
    y1, y2 = threefry2x32(k, np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([y1[0], y2[0]], np.uint32)


def _counters(shape: tuple[int, ...]) -> tuple[np.ndarray, np.ndarray]:
    """``prng.py::iota_2x32_shape``: each element's row-major index as a
    64-bit integer, its high and low words."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        idx = np.arange(n, dtype=np.uint64)
        return (idx >> np.uint64(32)).astype(np.uint32), idx.astype(np.uint32)
    return np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)


def split(k: Key, num: int = 2) -> np.ndarray:
    """``jax.random.split(k, num)``: ``[num, 2]`` keys."""
    y1, y2 = threefry2x32(k, *_counters((num,)))
    return np.stack([y1, y2], axis=-1)


def random_bits(k: Key, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bits(k, shape)`` (32-bit): the two words of each
    element's hash xored."""
    y1, y2 = threefry2x32(k, *_counters(tuple(shape)))
    return (y1 ^ y2).reshape(shape)


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` in float32 with one rounding, as XLA fuses it: the
    product of two float32 values is exact in float64."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _horner(coeffs, x: np.ndarray) -> np.ndarray:
    """The polynomial with ``coeffs`` (highest power first) at ``x``, in
    float32 by fused multiply-adds as XLA evaluates it (``_fma``, in place)."""
    x64 = x.astype(np.float64)
    step = np.empty_like(x64)
    p = np.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        np.multiply(p, x64, out=step)
        step += np.float32(c)
        p[...] = step                           # one rounding to float32
    return p


def uniform(k: Key, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``: 23 random
    mantissa bits under the exponent of 1, less 1, scaled, and held at or
    above ``minval``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(k, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


# XLA's float32 inverse error function (M. Giles, "Approximating the erfinv
# function", GPU Computing Gems, 2011): a polynomial in w - 2.5 for
# w = -log1p(-x*x) < 5, else in sqrt(w) - 3, times x
_ERFINV_SMALL = np.array([2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                          0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                          1.50140941], np.float32)
_ERFINV_LARGE = np.array([-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                          0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                          2.83297682], np.float32)


def _f32(bits: int) -> np.float32:
    return np.array([bits], np.uint32).view(np.float32)[0]


# XLA's float32 log on the CPU (the Cephes library's logf): the mantissa m
# in [sqrt(1/2), sqrt 2) less 1, a polynomial in it, the exponent's share of
# log 2 in two parts; every product and sum fused as XLA fuses them
_LOG_P = [_f32(h) for h in (0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A, 0xBDFE5D4F, 0x3E11E9BF,
                            0xBE2AAE50, 0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)]
_LOG_Q1, _LOG_Q2, _SQRT_HALF = _f32(0xB95E8083), _f32(0x3F318000), _f32(0x3F3504F3)


def _log(x: np.ndarray) -> np.ndarray:
    bits = x.view(np.uint32)
    e = np.float32(1.0) + ((bits >> np.uint32(23)).astype(np.int32) - 0x7F).astype(np.float32)
    m = ((bits & np.uint32(0x807FFFFF)) | np.uint32(0x3F000000)).view(np.float32)  # [0.5, 1)
    low = m < _SQRT_HALF
    e = e - low.astype(np.float32)
    m = (m - np.float32(1.0)) + np.where(low, m, np.float32(0.0))
    m2 = m * m
    m3 = m2 * m
    y = _fma(_fma(m, _LOG_P[0], _LOG_P[1]), m, _LOG_P[2])
    y1 = _fma(_fma(m, _LOG_P[3], _LOG_P[4]), m, _LOG_P[5])
    y2 = _fma(_fma(m, _LOG_P[6], _LOG_P[7]), m, _LOG_P[8])
    y = _fma(_fma(_fma(y, m3, y1), m3, y2), m3, e * _LOG_Q1)
    return ((m - m2 * np.float32(0.5)) + y) + e * _LOG_Q2


# XLA's float32 log1p: below sqrt(2) - 1 in magnitude x - x^2/2 + x^3
# P(x)/Q(x) (Cephes), else the log of 1 + x rounded to float32
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969,
            2.9911919328553140113533e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
            3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _log1p(x: np.ndarray) -> np.ndarray:
    out = np.empty_like(x)
    small = np.abs(x) < np.float32(math.sqrt(2.0) - 1.0)
    xs = x[small]
    p, q = _horner(_LOG1P_P, xs), _horner(_LOG1P_Q, xs)
    xx = xs * xs
    out[small] = xs + _fma(np.float32(-0.5), xx, (xs * xx) * (p / q))
    out[~small] = _log(x[~small] + np.float32(1.0))
    return out


def _sqrt2_erfinv(u: np.ndarray) -> np.ndarray:
    """``sqrt(2) * erf_inv(u)`` in float32, by XLA's polynomial: its
    float32 ``x*x`` drives its error in the tails (tens of units in the
    last place against the true function), so the port takes the same."""
    u = np.asarray(u, np.float32)
    w = -_log1p(-(u * u))
    out = np.empty_like(u)
    small = w < np.float32(5.0)
    for part, coeffs, t in ((small, _ERFINV_SMALL, w[small] - np.float32(2.5)),
                            (~small, _ERFINV_LARGE, np.sqrt(w[~small]) - np.float32(3.0))):
        out[part] = _horner(coeffs, t) * u[part]
    return _SQRT2 * out


def normal(k: Key, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(k, shape)`` (``_normal_real``): a uniform on
    ``[nextafter(-1, 0), 1)`` through ``sqrt(2) * erf_inv``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return _sqrt2_erfinv(uniform(k, shape, lo, 1.0))


def _erf_f32(x: float) -> np.float32:
    return np.float32(math.erf(float(np.float32(x) / _SQRT2)))


def truncated_normal(k: Key, lower: float, upper: float,
                     shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.truncated_normal(k, lower, upper, shape)``: a uniform
    on ``[erf(lower/sqrt 2), erf(upper/sqrt 2))`` through ``sqrt(2) *
    erf_inv``, held inside the open interval ``(lower, upper)``."""
    lo, hi = np.float32(lower), np.float32(upper)
    out = _sqrt2_erfinv(uniform(k, shape, _erf_f32(lo), _erf_f32(hi)))
    return np.clip(out, np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf)))
