"""JAX's and flax's parameter draws, in numpy.

Without pretrained weights SVFID and SIFID score on a random trunk:
``C3D.init(PRNGKey(seed))`` and ``InceptionStem.init(PRNGKey(seed))`` in
the JAX package (``hpvaegan_tpu/eval/c3d.py:191-195``,
``hpvaegan_tpu/eval/_sifid.py:188-192``).  A random score is only
comparable to another drawn on the same trunk, so the port draws the
trunk as flax draws it, without JAX:

* ``threefry2x32``: the 20-round Threefry-2x32 hash
  (``jax/_src/prng.py`` ``_threefry2x32_lowering``);
* ``prng_key``, ``fold_in`` and ``random_bits`` in the partitionable
  layout (``jax_threefry_partitionable=True``, jax 0.9's default): the
  counter of element ``i`` is the 64-bit ``i`` split into two words,
  and the 32 bits are the two hashed words XOR-ed;
* ``uniform`` in f32: the top 23 bits as a mantissa of ``[1, 2)``,
  minus 1, then ``u * (max - min) + min`` as one fused multiply-add,
  and ``max(min, .)``;
* ``truncated_normal`` on ``(-2, 2)``: uniform between the f32
  ``erf(-2/sqrt 2)`` and ``erf(2/sqrt 2)`` (hard-coded below), times
  ``sqrt 2 * erf_inv``, clipped to ``nextafter`` of the bounds;
* ``erf_inv``: XLA's f32 expansion (Giles' polynomial on
  ``w = -log1p(-x * x)``), with XLA's CPU ``log1p`` (Cephes' rational
  below ``sqrt 2 - 1``, else Cephes' ``logf`` of ``1 + x``) and the
  multiply-adds that XLA's CPU code fuses (``_fma``);
* ``lecun_normal``: stddev ``sqrt(1 / fan_in) / 0.87962566103423978`` in
  f32, ``fan_in = prod(kernel shape[:-1])``;
* ``flax_param_key``: a layer's first ``params`` key,
  ``fold_in(key, u32)`` with ``u32`` the first 4 bytes, big-endian, of
  ``sha1(name + b"\\x01")`` (``flax/core/scope.py`` ``_fold_in_static``,
  with ``flax_fix_rng_separator`` off: no separator byte).

The trunks equal the JAX package's bit for bit on the CPU of the JAX
package's tests (``tests/test_torch_port_jax_init.py`` holds every
weight of the C3D trunk to ``conv3b`` and of the stem to ``pool1``, at
two seeds).  XLA on another backend may compute ``erf_inv`` otherwise;
the JAX package's random trunk is the CPU's.
"""
from __future__ import annotations

import hashlib
import math
from typing import Sequence, Tuple

import numpy as np

__all__ = ["threefry2x32", "prng_key", "fold_in", "random_bits", "uniform",
           "erf_inv", "truncated_normal", "lecun_normal", "flax_param_key",
           "ERF_LO", "ERF_HI"]

_U32 = np.uint32
_F32 = np.float32

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)

# f32 erf(-2 / sqrt 2) and erf(2 / sqrt 2) as XLA computes them (bits
# 0xbf745a18 and 0x3f745a18); tests/test_torch_port_jax_init.py holds
# them against jax
ERF_LO = np.array(0xBF745A18, _U32).view(_F32)[()]
ERF_HI = np.array(0x3F745A18, _U32).view(_F32)[()]


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 of the word pairs ``(x0, x1)`` under ``key`` (2,)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (x1 << _U32(r)) | (x1 >> _U32(32 - r))
            x1 = x0 ^ x1
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (a 32-bit seed): ``[0, seed]``."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of ``[0, data]``."""
    y0, y1 = threefry2x32(key, np.zeros(1, _U32),
                          np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([y0[0], y1[0]], _U32)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """32 random bits an element (``_threefry_random_bits_partitionable``)."""
    n = math.prod(shape)
    count = np.arange(n, dtype=np.uint64)
    y0, y1 = threefry2x32(key, (count >> np.uint64(32)).astype(_U32),
                          count.astype(_U32))
    return (y0 ^ y1).reshape(shape)


def _fma(a, b, c) -> np.ndarray:
    """f32 ``a * b + c`` rounded once.  The f32 product is exact in f64;
    the f64 sum is exact up to ``err`` (TwoSum), and rounding it to f32
    again can only go wrong when it lands on an f32 midpoint, which
    ``err`` then decides."""
    a, b, c = np.broadcast_arrays(np.asarray(a, _F32), np.asarray(b, _F32),
                                  np.asarray(c, _F32))
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    out = s.astype(_F32)
    # an f64 on an f32 midpoint has its 29 dropped mantissa bits at 1 << 28
    low = s.view(np.uint64) & np.uint64((1 << 29) - 1)
    fix = (low == np.uint64(1 << 28)) & (err != 0) & np.isfinite(s)
    if fix.any():
        # the f32 neighbours of the midpoint: take the one err leans to
        r, mid = out[fix], s[fix]
        up = r.astype(np.float64) < mid
        below = np.where(up, r, np.nextafter(r, _F32(-np.inf)))
        above = np.where(up, np.nextafter(r, _F32(np.inf)), r)
        out[fix] = np.where(err[fix] > 0, above, below)
    return out


def uniform(key: np.ndarray, shape: Sequence[int], minval=0.0,
            maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    bits = random_bits(key, shape)
    one = np.array(1.0, _F32).view(_U32)
    floats = ((bits >> _U32(9)) | one).view(_F32) - _F32(1.0)
    lo, hi = _F32(minval), _F32(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


# Giles' single-precision erf_inv (XLA's ErfInv32): w < 5, else
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p below sqrt(2) - 1 (Cephes): x - x^2/2 + x^3 * N(x) / D(x)
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
# Cephes' logf, as XLA's CPU code emits it
_LOGF_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
           -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
           2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOGF_Q1, _LOGF_Q2 = -2.12194440e-4, 0.693359375


def _logf(v: np.ndarray) -> np.ndarray:
    """XLA's CPU f32 log of positive normal ``v``: ``v = 2^e * m``,
    ``m`` in ``[sqrt(1/2), sqrt 2)``, then Cephes' polynomial in
    ``m - 1``."""
    v = np.maximum(np.asarray(v, _F32),
                   np.array(0x00800000, _U32).view(_F32))
    bits = v.view(_U32)
    e = _F32(1.0) + ((bits >> _U32(23)).astype(np.int32) - 127).astype(_F32)
    x = ((bits & _U32(0x807FFFFF)) | np.array(0.5, _F32).view(_U32)
         ).view(_F32)
    small = x < _F32(0.707106781186547524)
    tmp = np.where(small, x, _F32(0.0))
    x = x - _F32(1.0)
    e = e - np.where(small, _F32(1.0), _F32(0.0))
    x = x + tmp
    x2 = x * x
    x3 = x2 * x
    p = _LOGF_P
    y = _fma(x, p[0], p[1])
    y1 = _fma(x, p[3], p[4])
    y2 = _fma(x, p[6], p[7])
    y = _fma(y, x, p[2])
    y1 = _fma(y1, x, p[5])
    y2 = _fma(y2, x, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, _F32(_LOGF_Q1) * e)
    x = x - x2 * _F32(0.5)
    x = x + y
    return x + _F32(_LOGF_Q2) * e


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, c)
    return p


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's CPU f32 log1p."""
    x = np.asarray(x, _F32)
    x2 = x * x
    small = (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)).astype(_F32)
    small = _fma(_F32(-0.5), x2, (x * x2) * small)
    small = x + small
    large = _logf(x + _F32(1.0))
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv`` (the CPU's; ``|x| < 1``)."""
    x = np.asarray(x, _F32)
    w = -_log1p(x * -x)
    lt = w < _F32(5.0)
    w = np.where(lt, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    p = np.where(lt, _F32(_ERFINV_SMALL[0]), _F32(_ERFINV_LARGE[0]))
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        p = _fma(p, w, np.where(lt, _F32(cs), _F32(cl)))
    out = p * x
    return np.where(np.abs(x) == _F32(1.0), np.copysign(_F32(np.inf), x),
                    out)


def truncated_normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.random.truncated_normal(key, -2, 2, shape, float32)``."""
    u = uniform(key, shape, ERF_LO, ERF_HI)
    out = np.array(np.sqrt(2), _F32) * erf_inv(u)
    return np.clip(out, np.nextafter(_F32(-2.0), _F32(np.inf)),
                   np.nextafter(_F32(2.0), _F32(-np.inf)))


def lecun_normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """``jax.nn.initializers.lecun_normal()(key, shape, float32)``: fan in
    over every axis but the last (flax's ``(*k, I, O)`` kernel)."""
    fan_in = math.prod(shape[:-1])
    variance = np.array(1.0 / fan_in, _F32)
    stddev = np.sqrt(variance) / _F32(0.87962566103423978)
    return truncated_normal(key, shape) * stddev


def flax_param_key(key: np.ndarray, name: str, counter: int = 1
                   ) -> np.ndarray:
    """The key of the ``counter``-th ``params`` draw in the top-level
    submodule ``name`` of a module initialised with ``key``."""
    digest = hashlib.sha1(
        name.encode("utf-8")
        + counter.to_bytes((counter.bit_length() + 7) // 8, "big")).digest()
    return fold_in(key, int.from_bytes(digest[:4], "big"))
