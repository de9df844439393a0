"""float32 ``atan2``, ``sin`` and ``cos`` with the bits of the reference's
compiled program, as plain tensor operations that give the same bits on the
card and on the CPU.

XLA:CPU lowers ``jnp.arctan2`` to a call of the C library's ``atan2f`` and a
``jnp.sin`` / ``jnp.cos`` pair of one argument to one ``sincosf`` (LLVM merges
them), from glibc (2.36, the version these were taken from). These are those
two functions, operation for operation:

* ``atan2``: glibc's ``__ieee754_atan2f`` and ``__atanf``
  (sysdeps/ieee754/flt-32/e_atan2f.c, s_atanf.c; fdlibm's float version), in
  float32 arithmetic with no fused multiply-adds: a reduction of ``|y/x|`` to
  one of five intervals, an odd/even split polynomial, the quadrant from the
  signs, and fdlibm's special cases for zeros, infinities and NaNs. XLA:CPU
  runs it with denormals-are-zero and flush-to-zero set, which ``y / x``
  shows: subnormal operands read as zeros, a subnormal quotient flushes.
* ``sincos``: glibc's ``__sincosf`` (sysdeps/ieee754/flt-32/s_sincosf.c,
  sincosf.h; the FMA build x86-64 selects), in float64 arithmetic rounded
  once to float32: polynomials in ``x**2`` for ``|x| < 0.75``, a one-step
  reduction by pi/2 below 120 (``x - n * pi/2`` fused, reproduced exactly by
  splitting pi/2), and a 4/pi table reduction in integer arithmetic above.
  The polynomial's own fused multiply-adds are evaluated as a product and a
  sum: their float64 results differ in the last bits only, which moves the
  float32 result in about one of 2**28 arguments.

``torch.atan2``, ``torch.sin`` and ``torch.cos`` are other approximations
(and on the card, CUDA's): they part from these by an ulp on a few percent
of arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from ..util import device_const


def _f32(bits: int) -> float:
    return float(np.array(bits, np.uint32).view(np.float32))


# e_atan2f.c / s_atanf.c constants, by the bit patterns their decimal
# literals round to (aT[0]'s comment in the C source says 0x3eaaaaaa; its
# literal 3.3333334327e-01 is 0x3eaaaaab)
_PI_O_4 = _f32(0x3F490FDB)
_PI_O_2 = _f32(0x3FC90FDB)
_PI = _f32(0x40490FDB)
_PI_LO = _f32(0xB3BBBD2E)
_ATANHI = [_f32(b) for b in (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)]
_ATANLO = [_f32(b) for b in (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)]
_AT = [_f32(b) for b in (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
                         0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7)]
# float32 sums and products the C source folds at compile time
_ATAN_INF = float(np.float32(_ATANHI[3]) + np.float32(_ATANLO[3]))
_ATAN2_BIG = float(np.float32(_PI_O_2) + np.float32(0.5) * np.float32(_PI_LO))
_THREE_PI_O_4 = float(np.float32(3.0) * np.float32(_PI_O_4))
_F32_TINY = float(np.finfo(np.float32).tiny)


def _flush(v: torch.Tensor) -> torch.Tensor:
    """A subnormal as the zero of its sign: XLA:CPU runs its programs, and
    the library calls in them, with denormals-are-zero and flush-to-zero set,
    so y / x reads subnormal operands as zeros and flushes a subnormal
    quotient (the only place in these functions a subnormal can arise)."""
    return torch.where(v.abs() < _F32_TINY, v * 0.0, v)


def _atanf_tables(device):
    """Per interval of s_atanf.c's reduction (|x| < 11/16, < 19/16, < 39/16,
    beyond): t = (a x + b) / (c x + d), which is each interval's C expression
    operation for operation, and atan(t0) as hi + lo."""
    rows = [(2.0, -1.0, 1.0, 2.0), (1.0, -1.0, 1.0, 1.0), (1.0, -1.5, 1.5, 1.0), (0.0, -1.0, 1.0, 0.0)]
    return torch.tensor([r + (hi, lo) for r, hi, lo in zip(rows, _ATANHI, _ATANLO)],
                        dtype=torch.float32, device=device)


def _atanf(q: torch.Tensor) -> torch.Tensor:
    """glibc's float ``__atanf`` of q >= 0 (or NaN)."""
    iq = q.view(torch.int32)
    i = (iq >= 0x3F300000).long() + (iq >= 0x3F980000).long() + (iq >= 0x401C0000).long()
    # a gather, not an index: a 0-d index tensor would be read on the host
    coef = device_const("atanf_tables", q.device, _atanf_tables).index_select(
        0, i.reshape(-1)).reshape(*i.shape, 6)
    a, b, c, d, hi, lo = coef.unbind(-1)
    small = iq < 0x3EE00000                       # |x| < 7/16: no reduction
    xr = torch.where(small, q, (q * a + b) / (q * c + d))
    z = xr * xr
    w = z * z
    s1 = w * _AT[10] + _AT[8]
    for k in (6, 4, 2, 0):
        s1 = w * s1 + _AT[k]
    s2 = w * _AT[9] + _AT[7]
    for k in (5, 3, 1):
        s2 = w * s2 + _AT[k]
    p = xr * (z * s1 + w * s2)
    r = torch.where(small, xr - p, hi - ((p - lo) - xr))
    r = torch.where(iq < 0x31000000, q, r)        # |x| < 2**-29: x itself
    r = torch.where(iq >= 0x4C000000, _ATAN_INF, r)
    return torch.where(iq > 0x7F800000, q + q, r)


def atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 ``atan2(y, x)`` as glibc 2.36's ``atan2f`` under XLA:CPU."""
    y, x = torch.broadcast_tensors(y.to(torch.float32), x.to(torch.float32))
    y, x = y.contiguous(), x.contiguous()
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    inf = 0x7F800000
    neg_x, neg_y = hx < 0, hy < 0
    k = (iy - ix) >> 23
    z = _atanf(_flush(_flush(y) / _flush(x)).abs())
    z = torch.where(k > 60, _ATAN2_BIG, torch.where(neg_x & (k < -60), 0.0, z))
    # the quadrant: z, -z, pi - (z - pi_lo), (z - pi_lo) - pi; the last is
    # the third negated, exactly
    base = torch.where(neg_x, _PI - (z - _PI_LO), z)
    r = torch.where(neg_y, -base, base)
    # special cases, the last applied wins (the C code tests them in reverse)
    half_pi = torch.where(neg_y, -_PI_O_2, _PI_O_2)
    r = torch.where(iy == inf, half_pi, r)
    y_inf = iy == inf
    at_inf = torch.where(neg_x, torch.where(y_inf, _THREE_PI_O_4, _PI), torch.where(y_inf, _PI_O_4, 0.0))
    r = torch.where(ix == inf, torch.where(neg_y, -at_inf, at_inf), r)
    r = torch.where(ix == 0, half_pi, r)
    r = torch.where(iy == 0, torch.where(neg_x, torch.where(neg_y, -_PI, _PI), y), r)
    # x == 1 calls atanf(y), which the general path equals (atanf is odd)
    # but for a subnormal y: atanf returns it, the flushed quotient is 0
    r = torch.where((hx == 0x3F800000) & (iy < 0x00800000), y, r)
    return torch.where((ix > inf) | (iy > inf), x + y, r)


# sincosf_data.c: sign per quadrant, 2/pi * 2**24, pi/2, cosine c0..c4, sine s1..s3
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
# pi/2 split: n * _HPI_HI (41 bits) and n * _HPI_LO (12 bits) are exact for
# the |n| <= 77 below 120, and x - n * _HPI_HI is exact (Sterbenz)
_HPI_HI = float.fromhex("0x1.921FB54442p0")
_HPI_LO = _HPI - _HPI_HI
_COS = [float.fromhex(h) for h in ("0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
                                   "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")]
_SIN = [float.fromhex(h) for h in ("-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
                                   "-0x1.994eb3774cf24p-13")]
_PI63 = float.fromhex("0x1.921FB54442D18p-62")
# 4/pi to 192 bits, 8 new bits per entry
_INV_PIO4 = (0xA2, 0xA2F9, 0xA2F983, 0xA2F9836E, 0xF9836E4E, 0x836E4E44, 0x6E4E4415, 0x4E441529,
             0x441529FC, 0x1529FC27, 0x29FC2757, 0xFC2757D1, 0x2757D1F5, 0x57D1F534, 0xD1F534DD,
             0xF534DDC0, 0x34DDC0DB, 0xDDC0DB62, 0xC0DB6295, 0xDB629599, 0x6295993C, 0x95993C43,
             0x993C4390, 0x3C439041)


def _reduce_large(xi: torch.Tensor):
    """sincosf.h ``reduce_large``: (x mod pi/2 in float64, quadrant) for the
    float bit patterns ``xi`` (int64, >= 120)."""
    table = device_const("inv_pio4", xi.device,
                         lambda d: torch.tensor(_INV_PIO4, dtype=torch.int64, device=d))
    j = (xi >> 26) & 15
    shift = (xi >> 23) & 7
    m = ((xi & 0xFFFFFF) | 0x800000) << shift
    # take, not an index: a 0-d index tensor (one angle, as in se3.exp) would
    # be read on the host, a synchronization
    res0 = (m * table.take(j)) & 0xFFFFFFFF       # 32-bit product
    res1 = m * table.take(j + 4)                  # < 2**63: exact in int64
    res2 = m * table.take(j + 8)
    res0 = (res2 >> 32) | (res0 << 32)            # wraps as uint64 would
    res0 = res0 + res1
    n = ((res0 + (1 << 61)) >> 62) & 3
    res0 = res0 - (n << 62)
    return res0.to(torch.float64) * _PI63, n


def sincos(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float32 ``(sin(y), cos(y))`` as glibc 2.36's ``sincosf``. Each branch's
    reduction runs on every element; one polynomial evaluation follows on
    the selected (x, quadrant)."""
    y = y.to(torch.float32).contiguous()
    yi = y.view(torch.int32)
    top = (yi >> 20) & 0x7FF
    small, mid = top < 0x3F4, top < 0x42F           # |y| < 0.75 (pio4's top), < 120
    x = y.to(torch.float64)
    # |y| < 120: n the nearest quadrant, x - n * pi/2 fused (exact split)
    n = (x * _HPI_INV).to(torch.int32)
    n = (n + 0x800000) >> 24
    nd = n.to(torch.float64)
    xr = (x - nd * _HPI_HI) - nd * _HPI_LO
    # |y| >= 120 (finite): the table reduction; its sign and table follow
    # (n + sign bit), the sin/cos swap n alone
    xl, nl = _reduce_large(yi.to(torch.int64) & 0xFFFFFFFF)
    q = torch.where(small, 0, torch.where(mid, n.long(), nl + (yi < 0).long()))
    swap = torch.where(small, 0, torch.where(mid, n.long(), nl))
    xs = torch.where(small, x, torch.where(mid, xr, xl))
    # sincosf_poly: sign[q & 3] = +1, -1, -1, +1 on x; the table with the
    # negated cosine polynomial for q & 2 (a polynomial of negated
    # coefficients is the negated polynomial, exactly)
    xx = torch.where(((q + 1) & 2) != 0, -xs, xs)
    x2 = xs * xs
    x4 = x2 * x2
    x3 = x2 * xx
    c2 = x2 * _COS[4] + _COS[3]
    s1 = x2 * _SIN[2] + _SIN[1]
    c1 = x2 * _COS[1] + _COS[0]
    x5 = x3 * x2
    x6 = x4 * x2
    s = x3 * _SIN[0] + xx
    c = x4 * _COS[2] + c1
    sin_p = (x5 * s1 + s).to(torch.float32)
    cos_p = (x6 * c2 + c).to(torch.float32)
    cos_p = torch.where((q & 2) != 0, -cos_p, cos_p)
    odd = (swap & 1) == 1
    sin, cos = torch.where(odd, cos_p, sin_p), torch.where(odd, sin_p, cos_p)
    nan = top >= 0x7F8
    sin = torch.where(nan, y - y, sin)
    cos = torch.where(nan, y - y, cos)
    tiny = top < 0x398                                   # |y| < 2**-12
    return torch.where(tiny, y, sin), torch.where(tiny, 1.0, cos)


def sin(y: torch.Tensor) -> torch.Tensor:
    """float32 ``sin(y)`` as XLA:CPU computes it (``sinf`` shares sincosf's
    reductions and polynomial)."""
    return sincos(y)[0]


def cos(y: torch.Tensor) -> torch.Tensor:
    """float32 ``cos(y)`` as XLA:CPU computes it."""
    return sincos(y)[1]


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """float32 ``sqrt`` correctly rounded, as XLA:CPU's ``vsqrtss`` and CUDA's
    ``sqrtf`` give it: torch's CPU kernel (the AVX-512 build) is an ulp off
    on about 1 % of arguments. The float64 root of a float32 rounds once to
    the correctly rounded float32 root."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)
