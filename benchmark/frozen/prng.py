"""A frozen copy of the port's host draws of ``jax.random``'s default stream
(``fitslam_tpu_torch/utils/prng.py:53-231``, copied verbatim), so that the
benchmark's worlds stay the same whatever a later change does to the port.
``benchmark/tests/test_frozen.py`` holds it bit-equal to the port's copy.

Everything is host numpy ``uint32``/``float32``/``int32``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def prng_key(seed: int) -> np.ndarray:
    """The raw (2,) uint32 key of ``jax.random.PRNGKey(seed)`` with 64-bit
    types off."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry_2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    (2,) uint32 key; uint32 arithmetic wraps as the cipher requires."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)`` under the partitionable
    Threefry scheme."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b0, b1 = threefry_2x32(key, hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: np.ndarray, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    floats = ((bits >> np.uint32(32 - 23)) | one).view(np.float32) - np.float32(1.0)
    span = np.float64(hi - lo)
    scaled = (floats.astype(np.float64) * span + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)



def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    b0, b1 = threefry_2x32(key, np.zeros(num, np.uint32), np.arange(num, dtype=np.uint32))
    return np.stack([b0, b1], axis=-1)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the key of ``data`` (taken as uint32)."""
    b0, b1 = threefry_2x32(key, np.zeros(1, np.uint32),
                           np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b0[0], b1[0]], np.uint32)


def bernoulli(key: np.ndarray, p: float = 0.5, shape: Sequence[int] = ()) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` for a float32 ``p``: bool."""
    return uniform(key, shape) < np.float32(p)


def randint(key: np.ndarray, shape: Sequence[int], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32): the high
    and low 32-bit streams of ``split(key)``'s two keys, reduced modulo the
    span with the multiplier 2**32 mod span, all in wrapping uint32."""
    i32 = np.iinfo(np.int32)
    lo = int(np.clip(minval, i32.min, i32.max))
    hi = int(np.clip(maxval, i32.min, i32.max))
    k1, k2 = split(key)
    higher, lower = random_bits(k1, shape), random_bits(k2, shape)
    if hi <= lo:
        span = 1
    else:
        span = (hi - lo) & 0xFFFFFFFF
        if maxval > i32.max:
            span = (span + 1) & 0xFFFFFFFF
    mask = np.uint64(0xFFFFFFFF)
    if span == 0:   # the span wrapped to 2**32: XLA's remainder by 0 keeps the
        offset = lower.astype(np.uint64)   # dividend and the multiplier wraps to 0
    else:
        s = np.uint64(span)
        # 2**16 mod span, squared in wrapping uint32 (2**32 wraps to 0), mod span
        mult = np.uint64((((2 ** 16 % span) ** 2) & 0xFFFFFFFF) % span)
        offset = ((higher.astype(np.uint64) % s) * mult) & mask
        offset = ((offset + lower.astype(np.uint64) % s) & mask) % s
    return (np.int64(lo) + offset.astype(np.int64)).astype(np.int32)


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once (XLA's CPU contracts the pair)."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(np.float32)


_F = np.float32
# XLA's CPU log1p below sqrt(2) - 1: x + (-x^2 / 2 + x^3 P(x) / Q(x)) (Cephes)
_LOG1P_NUM = tuple(_F(c) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1, 6.5787325942061044846969e0,
    2.9911919328553073277375e1, 6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_LOG1P_DEN = tuple(_F(c) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1, 2.2176239823732856465394e2,
    3.0909872225312059774938e2, 2.1642788614495947685003e2, 6.0118660497603843919306e1))
# XLA's CPU float32 log (Cephes logf on the frexp mantissa)
_LOG_P = tuple(_F(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1, 1.4249322787e-1,
    -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
# XLA's float32 ErfInv: coefficients for w < 5 and for w >= 5
_ERFINV_LT5 = tuple(_F(c) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = tuple(_F(c) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def _poly(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def _log_f32(v: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log`` of positive normal ``v``."""
    m, e = np.frexp(v)                    # v = m 2**e, m in [0.5, 1)
    m, e = m.astype(np.float32), e.astype(np.float32)
    small = m < _F(0.707106781186547524)
    x = (m - _F(1)) + np.where(small, m, _F(0))
    e = e - np.where(small, _F(1), _F(0))
    x2 = x * x
    x3 = x2 * x
    y = _fma(_fma(x, _LOG_P[0], _LOG_P[1]), x, _LOG_P[2])
    y1 = _fma(_fma(x, _LOG_P[3], _LOG_P[4]), x, _LOG_P[5])
    y2 = _fma(_fma(x, _LOG_P[6], _LOG_P[7]), x, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _F(-2.12194440e-4) * e)
    x = _fma(_F(-0.5), x2, x) + y
    return x + _F(0.693359375) * e


def _log1p_f32(x: np.ndarray) -> np.ndarray:
    """XLA's CPU float32 ``log1p`` for x in (-1, 0]."""
    x2 = x * x
    r = _poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)
    small = x + _fma(_F(-0.5), x2, (x * x2) * r)
    with np.errstate(divide="ignore", invalid="ignore"):
        large = _log_f32(np.maximum(_F(1) + x, np.finfo(np.float32).tiny))
    return np.where(np.abs(x) < _F(0.41421356237309504880), small, large)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's float32 ``ErfInv`` (``chlo.erf_inv``) for x in (-1, 1), +-inf at
    +-1."""
    x = np.asarray(x, np.float32)
    w = -_log1p_f32(x * -x)
    lt = w < _F(5)
    with np.errstate(invalid="ignore"):
        w = np.where(lt, w - _F(2.5), np.sqrt(w) - _F(3))
    p = np.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).astype(np.float32)
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = _fma(p, w, np.where(lt, c_lt, c_ge))
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(np.abs(x) == _F(1), x * _F(np.inf), p * x).astype(np.float32)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.normal(key, shape)`` (float32)."""
    lo = np.nextafter(_F(-1), _F(0))
    u = uniform(key, shape, lo, _F(1))
    return (_F(np.sqrt(2)) * erf_inv(u)).astype(np.float32)
