"""Curve25519 / ristretto255 on Python integers, for the plain reference.

A frozen copy of the port's host curve code: the field GF(2^255 - 19), the
scalar field mod l, Edwards points in extended coordinates, and the
ristretto255 encoding (compress, decompress, from_uniform_bytes).  The
benchmark's reference verifier is built on it and imports nothing of the
port, so a later change to the port cannot change the yardstick.
"""

from __future__ import annotations

from dataclasses import dataclass

# ---------------------------------------------------------------------------
# Field constants
# ---------------------------------------------------------------------------

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493  # Ristretto group order

D = (-121665 * pow(121666, P - 2, P)) % P  # Edwards d
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1), the canonical (even) root is fixed below

INVSQRT_A_MINUS_D = None  # filled in below
SQRT_AD_MINUS_ONE = None


def _is_neg(x: int) -> bool:
    """Field element 'negative' == lowest bit of canonical encoding is 1."""
    return (x % P) & 1 == 1


def _abs_fe(x: int) -> int:
    x %= P
    return P - x if _is_neg(x) else x


def sqrt_ratio_i(u: int, v: int) -> tuple[bool, int]:
    """Compute sqrt(u/v) in GF(p) using the 2^((p-5)/8) trick.

    Returns (was_square, r) with r = sqrt(u/v) if u/v is square, else
    r = sqrt(SQRT_M1 * u/v); r is always the non-negative root.
    Mirrors curve25519-dalek `FieldElement::sqrt_ratio_i`.
    """
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P

    correct_sign = check == u
    flipped_sign = check == (-u) % P
    flipped_sign_i = check == (-u) % P * SQRT_M1 % P

    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P

    if _is_neg(r):
        r = P - r

    return (correct_sign or flipped_sign), r


def invsqrt(x: int) -> tuple[bool, int]:
    return sqrt_ratio_i(1, x)


# invsqrt(a - d) with a = -1
_ok, INVSQRT_A_MINUS_D = invsqrt((-1 - D) % P)
assert _ok
# sqrt(a*d - 1) with a = -1: a*d - 1 = -d - 1.  dalek / RFC 9496 pin the
# NEGATIVE (odd) root for this constant, unlike sqrt_ratio_i's convention.
_ok, SQRT_AD_MINUS_ONE = sqrt_ratio_i((-D - 1) % P, 1)
assert _ok
SQRT_AD_MINUS_ONE = P - SQRT_AD_MINUS_ONE
assert SQRT_AD_MINUS_ONE & 1 == 1 and SQRT_AD_MINUS_ONE**2 % P == (-D - 1) % P

# ---------------------------------------------------------------------------
# Edwards points (extended coordinates)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EdwardsPoint:
    """Point on -x^2 + y^2 = 1 + d x^2 y^2 in extended coords (X:Y:Z:T), XY=ZT."""

    X: int
    Y: int
    Z: int
    T: int

    @staticmethod
    def identity() -> "EdwardsPoint":
        return EdwardsPoint(0, 1, 1, 0)

    def double(self) -> "EdwardsPoint":
        # dbl-2008-hwcd, a = -1
        X1, Y1, Z1 = self.X, self.Y, self.Z
        A = X1 * X1 % P
        B = Y1 * Y1 % P
        C = 2 * Z1 * Z1 % P
        H = (A + B) % P
        E = (H - (X1 + Y1) * (X1 + Y1)) % P
        G = (A - B) % P
        F = (C + G) % P
        return EdwardsPoint(E * F % P, G * H % P, F * G % P, E * H % P)

    def __add__(self, other: "EdwardsPoint") -> "EdwardsPoint":
        # add-2008-hwcd-3, a = -1 (the formula dalek uses via cached points)
        X1, Y1, Z1, T1 = self.X, self.Y, self.Z, self.T
        X2, Y2, Z2, T2 = other.X, other.Y, other.Z, other.T
        A = (Y1 - X1) * (Y2 - X2) % P
        B = (Y1 + X1) * (Y2 + X2) % P
        C = T1 * 2 * D % P * T2 % P
        Dv = Z1 * 2 % P * Z2 % P
        E = (B - A) % P
        F = (Dv - C) % P
        G = (Dv + C) % P
        H = (B + A) % P
        return EdwardsPoint(E * F % P, G * H % P, F * G % P, E * H % P)

    def __neg__(self) -> "EdwardsPoint":
        return EdwardsPoint((-self.X) % P, self.Y, self.Z, (-self.T) % P)

    def __sub__(self, other: "EdwardsPoint") -> "EdwardsPoint":
        return self + (-other)

    def scalar_mul(self, n: int) -> "EdwardsPoint":
        n %= L
        acc = EdwardsPoint.identity()
        base = self
        while n:
            if n & 1:
                acc = acc + base
            base = base.double()
            n >>= 1
        return acc

    __mul__ = scalar_mul
    __rmul__ = scalar_mul

    def affine(self) -> tuple[int, int]:
        zi = pow(self.Z, P - 2, P)
        return self.X * zi % P, self.Y * zi % P

    def ristretto_eq(self, other: "EdwardsPoint") -> bool:
        """Equality in the Ristretto quotient group:
        X1*Y2 == Y1*X2 or Y1*Y2 == -X1*X2 (a = -1 => Y1*Y2 == X1*X2 check sign)."""
        a = self.X * other.Y % P == self.Y * other.X % P
        b = self.Y * other.Y % P == self.X * other.X % P
        return a or b


# Ed25519 basepoint: y = 4/5, x the even root.
_by = 4 * pow(5, P - 2, P) % P
_bx2 = (_by * _by - 1) * pow(D * _by % P * _by % P + 1, P - 2, P) % P
_ok, _bx = sqrt_ratio_i((_by * _by - 1) % P, (D * _by % P * _by % P + 1) % P)
assert _ok
# take the even (non-negative) root, then match the standard sign convention:
# the canonical ed25519 basepoint has even x (sign bit 0) -- _bx is already abs.
ED25519_BASEPOINT = EdwardsPoint(_bx, _by, 1, _bx * _by % P)

# ---------------------------------------------------------------------------
# Ristretto encoding
# ---------------------------------------------------------------------------


def ristretto_compress(pt: EdwardsPoint) -> bytes:
    X, Y, Z, T = pt.X % P, pt.Y % P, pt.Z % P, pt.T % P
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    _, invsqrt_ = invsqrt(u1 * u2 % P * u2 % P)
    den1 = invsqrt_ * u1 % P
    den2 = invsqrt_ * u2 % P
    z_inv = den1 * den2 % P * T % P
    ix = X * SQRT_M1 % P
    iy = Y * SQRT_M1 % P
    enchanted_denominator = den1 * INVSQRT_A_MINUS_D % P
    rotate = _is_neg(T * z_inv % P)
    if rotate:
        X, Y = iy, ix
        den_inv = enchanted_denominator
    else:
        den_inv = den2
    if _is_neg(X * z_inv % P):
        Y = (-Y) % P
    s = den_inv * (Z - Y) % P
    if _is_neg(s):
        s = (-s) % P
    return s.to_bytes(32, "little")


def ristretto_decompress(data: bytes) -> EdwardsPoint | None:
    if len(data) != 32:
        return None
    s = int.from_bytes(data, "little")
    if s >= P:  # non-canonical
        return None
    if _is_neg(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-(D * u1 % P) * u1 % P - u2_sqr) % P
    ok, invsqrt_ = invsqrt(v * u2_sqr % P)
    if not ok:
        return None
    den_x = invsqrt_ * u2 % P
    den_y = invsqrt_ * den_x % P * v % P
    x = _abs_fe(2 * s % P * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if _is_neg(t) or y == 0:
        return None
    return EdwardsPoint(x, y, 1, t)


def _map_to_point(r0: int) -> EdwardsPoint:
    """The ristretto255 Elligator 2 map (dalek `RistrettoPoint::elligator_ristretto_flavor`)."""
    r = SQRT_M1 * r0 % P * r0 % P
    N_s = (r + 1) % P * ((1 - D * D % P) % P) % P
    c = (-1) % P
    Dv = (c - D * r % P) % P * ((r + D) % P) % P
    Ns_D_is_sq, s = sqrt_ratio_i(N_s, Dv)
    s_prime = _abs_fe(s * r0 % P)
    s_prime = (-s_prime) % P  # s' must be negative
    if not Ns_D_is_sq:
        s = s_prime
        c = r
    N_t = (c * (r - 1) % P * ((D - 1) * (D - 1) % P) % P - Dv) % P
    ss = s * s % P
    W0 = 2 * s % P * Dv % P
    W1 = N_t * SQRT_AD_MINUS_ONE % P
    W2 = (1 - ss) % P
    W3 = (1 + ss) % P
    return EdwardsPoint(
        W0 * W3 % P, W2 * W1 % P, W1 * W3 % P, W0 * W2 % P
    )


def ristretto_from_uniform_bytes(data: bytes) -> EdwardsPoint:
    """dalek `RistrettoPoint::from_uniform_bytes` (the RFC 9496 one-way map)."""
    if len(data) != 64:
        raise ValueError("need 64 bytes")
    r0 = int.from_bytes(data[:32], "little") & ((1 << 255) - 1)
    r1 = int.from_bytes(data[32:], "little") & ((1 << 255) - 1)
    return _map_to_point(r0 % P) + _map_to_point(r1 % P)


RISTRETTO_BASEPOINT = ED25519_BASEPOINT

# ---------------------------------------------------------------------------
# Scalars mod L
# ---------------------------------------------------------------------------


def scalar_from_bytes_mod_order(b: bytes) -> int:
    assert len(b) == 32
    return int.from_bytes(b, "little") % L


def scalar_from_bytes_mod_order_wide(b: bytes) -> int:
    assert len(b) == 64
    return int.from_bytes(b, "little") % L


def scalar_from_bits(b: bytes) -> int:
    """dalek `Scalar::from_bits`: mask the top bit, NO canonical reduction.

    Bid entries and the public list go through this: values in [0, 2^255)
    are accepted as-is.  We replicate by keeping the raw integer;
    all arithmetic reduces mod L anyway, but serialization must round-trip the
    unreduced value, so callers that need the quirk keep the raw int.
    """
    assert len(b) == 32
    return int.from_bytes(b, "little") & ((1 << 255) - 1)


def scalar_to_bytes(s: int) -> bytes:
    return (s % L).to_bytes(32, "little")


def scalar_invert(s: int) -> int:
    return pow(s % L, L - 2, L)
