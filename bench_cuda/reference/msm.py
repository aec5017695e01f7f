"""Multi-scalar multiplication on Python integers (Pippenger, signed digits).

Points are Edwards points in extended coordinates as plain tuples (X, Y, Z,
T); each base is turned once into its cached form (Y + X, Y - X, 2 d T, 2 Z),
so a bucket addition costs 8 field products.  With c-bit signed windows a
product of N points costs about ceil(253 / c) (N + 2^c) additions.
"""

from __future__ import annotations

from .curve import D, L, P, EdwardsPoint

D2 = 2 * D % P
IDENTITY = (0, 1, 1, 0)


def cached(pt) -> tuple:
    X, Y, Z, T = pt
    return ((Y + X) % P, (Y - X) % P, T * D2 % P, 2 * Z % P)


def _neg_cached(c) -> tuple:
    return (c[1], c[0], (-c[2]) % P, c[3])


def add_cached(p, c) -> tuple:
    X1, Y1, Z1, T1 = p
    A = (Y1 - X1) * c[1] % P
    B = (Y1 + X1) * c[0] % P
    C = T1 * c[2] % P
    Dv = Z1 * c[3] % P
    E, F, G, H = B - A, Dv - C, Dv + C, B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def add(p, q) -> tuple:
    return add_cached(p, cached(q))


def double(p) -> tuple:
    X1, Y1, Z1, _ = p
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = 2 * Z1 * Z1 % P
    H = A + B
    E = H - (X1 + Y1) * (X1 + Y1)
    G = A - B
    F = C + G
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def from_point(pt: EdwardsPoint) -> tuple:
    return (pt.X, pt.Y, pt.Z, pt.T)


def to_point(p) -> EdwardsPoint:
    return EdwardsPoint(p[0] % P, p[1] % P, p[2] % P, p[3] % P)


def _window(n: int) -> int:
    for c, below in ((4, 64), (6, 512), (8, 2048), (10, 16384), (12, 65536)):
        if n < below:
            return c
    return 14


def msm(scalars: list[int], points: list[tuple]) -> tuple:
    """sum_i scalars[i] * points[i] (scalars taken mod l)."""
    pairs = [(s % L, p) for s, p in zip(scalars, points) if s % L]
    if not pairs:
        return IDENTITY
    c = _window(len(pairs))
    half, full, mask = 1 << (c - 1), 1 << c, (1 << c) - 1
    windows = (253 + c) // c + 1
    digits = []  # signed c-bit digits of every scalar, lowest window first
    for s, _ in pairs:
        row = []
        carry = 0
        for _ in range(windows):
            d = (s & mask) + carry
            s >>= c
            carry = 1 if d >= half else 0
            row.append(d - full if carry else d)
        digits.append(row)
    bases = [cached(p) for _, p in pairs]
    negs = [_neg_cached(b) for b in bases]
    acc = IDENTITY
    for w in range(windows - 1, -1, -1):
        for _ in range(c):
            acc = double(acc)
        buckets = [None] * (half + 1)
        for row, b, nb in zip(digits, bases, negs):
            d = row[w]
            if d:
                idx, cb = (d, b) if d > 0 else (-d, nb)
                cur = buckets[idx]
                if cur is None:
                    # a bucket starts from its first point, back from cached form
                    cur = add_cached(IDENTITY, cb)
                else:
                    cur = add_cached(cur, cb)
                buckets[idx] = cur
        running, total = IDENTITY, IDENTITY
        for idx in range(half, 0, -1):
            if buckets[idx] is not None:
                running = add(running, buckets[idx])
            total = add(total, running)
        acc = add(acc, total)
    return acc


def is_identity(p) -> bool:
    """Ristretto equality with the identity: X == 0 or Y == 0 (the four
    points of E[4] encode the same group element)."""
    X, Y = p[0] % P, p[1] % P
    return X == 0 or Y == 0
