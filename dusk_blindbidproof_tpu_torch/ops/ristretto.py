"""Batched Ristretto compression and decompression on tensors, and the
field inversion chains they need.

The exponentiation x^(2^252 - 3) uses the standard ed25519 addition chain
(252 squarings + 11 multiplies): a fixed schedule, no data-dependent
control flow; on CUDA tensors its nine runs of squarings are nine launches.  The verifier decompresses the proof's points here.
"""

from __future__ import annotations

import torch

from ..utils import curve_host as host
from . import edwards, fused, limb
from .limb import FP

_SQRT_M1 = limb.int_to_limbs(host.SQRT_M1)
_INVSQRT_A_MINUS_D = limb.int_to_limbs(host.INVSQRT_A_MINUS_D)
_EDWARDS_D = limb.int_to_limbs(host.D)
_ONE = limb.int_to_limbs(1)


def _pow2k(x: torch.Tensor, k: int) -> torch.Tensor:
    """x^(2^k): runs of two or more squarings are one launch of the squaring
    chain on CUDA tensors."""
    if k >= 2:
        return fused.sqr_chain(FP, *fused.kernel_operands(x), k)
    for _ in range(k):
        x = limb.sqr(FP, x)
    return x


def pow_p58(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3), ed25519 reference addition chain."""
    def m(a, b):
        return limb.mul(FP, a, b)

    t0 = limb.sqr(FP, x)  # x^2
    t1 = m(_pow2k(t0, 2), x)  # x^9
    t2 = m(t0, t1)  # x^11
    t3 = m(limb.sqr(FP, t2), t1)  # x^31 = 2^5 - 1
    t4 = m(_pow2k(t3, 5), t3)  # 2^10 - 1
    t5 = m(_pow2k(t4, 10), t4)  # 2^20 - 1
    t6 = m(_pow2k(t5, 20), t5)  # 2^40 - 1
    t7 = m(_pow2k(t6, 10), t4)  # 2^50 - 1
    t8 = m(_pow2k(t7, 50), t7)  # 2^100 - 1
    t9 = m(_pow2k(t8, 100), t8)  # 2^200 - 1
    t10 = m(_pow2k(t9, 50), t7)  # 2^250 - 1
    return m(_pow2k(t10, 2), x)  # 2^252 - 3


def invert(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2): p-2 = 2^255 - 21 = 8*(2^252 - 3) + 3."""
    p58 = pow_p58(x)  # 2^252 - 3
    t = _pow2k(p58, 3)  # 2^255 - 24
    return limb.mul(FP, t, limb.mul(FP, limb.sqr(FP, x), x))  # + 3


def is_negative(x: torch.Tensor) -> torch.Tensor:
    """Canonical-encoding sign bit: lowest bit of canon(x)."""
    return (limb.canon(FP, x)[..., 0] & 1) == 1


def sqrt_ratio_i(u: torch.Tensor, v: torch.Tensor):
    """Batched dalek FieldElement::sqrt_ratio_i. Returns (was_square, r)."""
    sqrt_m1 = limb.const(_SQRT_M1, u.device)
    v3 = limb.mul(FP, limb.sqr(FP, v), v)
    v7 = limb.mul(FP, limb.sqr(FP, v3), v)
    r = limb.mul(FP, limb.mul(FP, u, v3), pow_p58(limb.mul(FP, u, v7)))
    check = limb.mul(FP, v, limb.sqr(FP, r))
    neg_u = limb.neg(FP, u)
    correct = limb.eq_mod(FP, check, u)
    flipped = limb.eq_mod(FP, check, neg_u)
    flipped_i = limb.eq_mod(FP, check, limb.mul(FP, neg_u, sqrt_m1))
    r = limb.select(flipped | flipped_i, limb.mul(FP, r, sqrt_m1), r)
    r = limb.select(is_negative(r), limb.neg(FP, r), r)
    return correct | flipped, r


def invsqrt(x: torch.Tensor):
    one = limb.const(_ONE, x.device).expand(x.shape)
    return sqrt_ratio_i(one, x)


def compress(pts: torch.Tensor) -> torch.Tensor:
    """[..., 4, NLIMBS] extended points -> [..., NLIMBS] canonical s limbs
    (`limb.limbs_to_bytes_le` gives the 32-byte wire encoding)."""
    X, Y = pts[..., 0, :], pts[..., 1, :]
    Z, T = pts[..., 2, :], pts[..., 3, :]
    sqrt_m1 = limb.const(_SQRT_M1, pts.device)
    u1 = limb.mul(FP, limb.add(FP, Z, Y), limb.sub(FP, Z, Y))
    u2 = limb.mul(FP, X, Y)
    _, inv = invsqrt(limb.mul(FP, u1, limb.sqr(FP, u2)))
    den1 = limb.mul(FP, inv, u1)
    den2 = limb.mul(FP, inv, u2)
    z_inv = limb.mul(FP, limb.mul(FP, den1, den2), T)
    ix = limb.mul(FP, X, sqrt_m1)
    iy = limb.mul(FP, Y, sqrt_m1)
    enchanted = limb.mul(FP, den1, limb.const(_INVSQRT_A_MINUS_D, pts.device))
    rotate = is_negative(limb.mul(FP, T, z_inv))
    Xp = limb.select(rotate, iy, X)
    Yp = limb.select(rotate, ix, Y)
    den_inv = limb.select(rotate, enchanted, den2)
    Yp = limb.select(is_negative(limb.mul(FP, Xp, z_inv)), limb.neg(FP, Yp), Yp)
    s = limb.mul(FP, den_inv, limb.sub(FP, Z, Yp))
    s = limb.select(is_negative(s), limb.neg(FP, s), s)
    return limb.canon(FP, s)


def decompress(s: torch.Tensor):
    """[..., NLIMBS] field encodings -> ([..., 4, NLIMBS] points, [...] valid).

    Canonicality of the 32-byte input (value < p, non-negative) must be
    checked by the caller on the raw bytes; this performs the curve math and
    the square/sign validity checks, returning identity for invalid rows.
    """
    one = limb.const(_ONE, s.device).expand(s.shape)
    ss = limb.sqr(FP, s)
    u1 = limb.sub(FP, one, ss)
    u2 = limb.add(FP, one, ss)
    u2_sqr = limb.sqr(FP, u2)
    d_l = limb.const(_EDWARDS_D, s.device)
    v = limb.sub(
        FP,
        limb.neg(FP, limb.mul(FP, d_l, limb.sqr(FP, u1))),
        u2_sqr,
    )
    ok, inv = invsqrt(limb.mul(FP, v, u2_sqr))
    den_x = limb.mul(FP, inv, u2)
    den_y = limb.mul(FP, limb.mul(FP, inv, den_x), v)
    x = limb.mul(FP, limb.add(FP, s, s), den_x)
    x = limb.select(is_negative(x), limb.neg(FP, x), x)
    y = limb.mul(FP, u1, den_y)
    t = limb.mul(FP, x, y)
    valid = ok & ~is_negative(t) & ~limb.is_zero(FP, y)
    pt = torch.stack([x, y, one, t], dim=-2)
    ident = edwards.identity(s.shape[:-1], device=s.device)
    return edwards.select(valid, pt, ident), valid
