"""The plain reference verifier of Bulletproofs R1CS proofs.

It replays the verifier's Merlin transcript (the schedule of the
`bulletproofs` crate's R1CS protocol, one phase) and reduces a proof to the
one multi-scalar product that must be the identity.  Proofs are checked
alone (`verify`) or many at once (`verify_many`): each proof's product is
weighted by a random scalar from the caller's generator and all are summed,
so the generators G and H are multiplied once.  A sum is the identity only
if every proof's is, but for a chance of about 2^-250.

Nothing here is taken from the program: the generators are derived again
(above `CACHE_FROM` kept in the checkout's build/ for its next runs),
the circuit is synthesized again from the public inputs, and a proof is read
from its wire bytes.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np

from . import msm
from .circuits import Circuit
from .curve import L, P, ristretto_decompress
from .generators import BulletproofGens, PedersenGens
from .merlin import Transcript

IDENTITY_COMPRESSED = b"\x00" * 32


class RefError(Exception):
    """A proof that is malformed: the reference's verdict is 'invalid'."""


@dataclass
class Proof:
    A_I1: bytes
    A_O1: bytes
    S1: bytes
    T: list  # T_1, T_3, T_4, T_5, T_6
    t_x: int
    t_x_blinding: int
    e_blinding: int
    ipp_L: list
    ipp_R: list
    ipp_a: int
    ipp_b: int


def _scalar(b: bytes) -> int:
    s = int.from_bytes(b, "little")
    if s >= L:
        raise RefError("non-canonical scalar")
    return s


def parse_proof(data: bytes) -> Proof:
    """Wire bytes: a version byte (0 = one phase), the points A_I1 A_O1 S1
    (and A_I2 A_O2 S2 for version 1), T_1 T_3 T_4 T_5 T_6, the scalars t_x,
    t_x_blinding, e_blinding, then L_j R_j of every round and a, b."""
    if len(data) < 33 or (len(data) - 1) % 32:
        raise RefError("bad proof length")
    if data[0] != 0:
        raise RefError("the cells' circuits are one-phase")
    ch = [data[1 + 32 * i:33 + 32 * i] for i in range((len(data) - 1) // 32)]
    if len(ch) < 3 + 5 + 3 + 2 or (len(ch) - 13) % 2:
        raise RefError("bad proof length")
    ipp = ch[11:-2]
    return Proof(A_I1=ch[0], A_O1=ch[1], S1=ch[2], T=ch[3:8], t_x=_scalar(ch[8]),
                 t_x_blinding=_scalar(ch[9]), e_blinding=_scalar(ch[10]),
                 ipp_L=ipp[0::2], ipp_R=ipp[1::2], ipp_a=_scalar(ch[-2]),
                 ipp_b=_scalar(ch[-1]))


def _point(data: bytes) -> tuple:
    pt = ristretto_decompress(data)
    if pt is None:
        raise RefError("invalid point encoding")
    return msm.from_point(pt)


def _challenge(t: Transcript, label: bytes) -> int:
    return int.from_bytes(t.challenge_bytes(label, 64), "little") % L


# above this capacity the derived generators are kept for the checkout's next
# runs (a minute of hashing and square roots at 2^16)
CACHE_FROM = 8192
CACHE_DIR = Path(__file__).resolve().parents[2] / "build" / "bench_cuda"


def _derive(cap: int) -> list[tuple]:
    bp = BulletproofGens(cap)
    G, H = bp.share(0)
    return [msm.from_point(p) for p in G + H]


def _cached(cap: int) -> list[tuple]:
    """G then H, kept as affine (x, y) pairs of 32-byte integers."""
    path = CACHE_DIR / f"generators_{cap}.bin"
    size = 2 * cap * 64
    if path.is_file() and path.stat().st_size == size:
        data = path.read_bytes()
        out = []
        for off in range(0, size, 64):
            x = int.from_bytes(data[off:off + 32], "little")
            y = int.from_bytes(data[off + 32:off + 64], "little")
            out.append((x, y, 1, x * y % P))
        return out
    points = _derive(cap)
    blob = bytearray()
    for X, Y, Z, _ in points:
        zi = pow(Z, P - 2, P)
        blob += (X * zi % P).to_bytes(32, "little") + (Y * zi % P).to_bytes(32, "little")
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    part = path.with_suffix(".part")
    part.write_bytes(bytes(blob))
    os.replace(part, path)
    return points


@lru_cache(maxsize=2)
def generators(cap: int):
    """(G, H, B, B_blinding) as tuples, derived on the host."""
    points = _cached(cap) if cap >= CACHE_FROM else _derive(cap)
    pc = PedersenGens.default()
    return (points[:cap], points[cap:], msm.from_point(pc.B), msm.from_point(pc.B_blinding))


@dataclass
class Challenges:
    y: int
    z: int
    u: int
    x: int
    w: int
    us: list  # one a round of the inner-product argument
    r: int


def replay(circuit: Circuit, proof: Proof, commitments: list[bytes], fork=None) -> Challenges:
    """The challenges of the proof's Merlin transcript.  `fork(transcript)`
    is called where the prover forks its blinding RNG: after the commitments
    and m."""
    t = Transcript(circuit.label)
    t.append_message(b"dom-sep", b"r1cs v1")
    for c in commitments:
        t.append_message(b"V", c)
    t.append_u64(b"m", circuit.m)
    if fork is not None:
        fork(t)
    for label, c in ((b"A_I1", proof.A_I1), (b"A_O1", proof.A_O1), (b"S1", proof.S1)):
        if c == IDENTITY_COMPRESSED:
            raise RefError("identity commitment")
        t.append_message(label, c)
    t.append_message(b"dom-sep", b"r1cs-1phase")
    for label in (b"A_I2", b"A_O2", b"S2"):
        t.append_message(label, IDENTITY_COMPRESSED)
    y = _challenge(t, b"y")
    z = _challenge(t, b"z")
    for label, c in zip((b"T_1", b"T_3", b"T_4", b"T_5", b"T_6"), proof.T):
        t.append_message(label, c)
    u = _challenge(t, b"u")
    x = _challenge(t, b"x")
    for label, s in ((b"t_x", proof.t_x), (b"t_x_blinding", proof.t_x_blinding),
                     (b"e_blinding", proof.e_blinding)):
        t.append_message(label, s.to_bytes(32, "little"))
    w = _challenge(t, b"w")
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_u64(b"n", circuit.n_pad)
    us = []
    for lb, rb in zip(proof.ipp_L, proof.ipp_R):
        t.append_message(b"L", lb)
        t.append_message(b"R", rb)
        us.append(_challenge(t, b"u"))
    return Challenges(y=y, z=z, u=u, x=x, w=w, us=us, r=_challenge(t, b"r"))


def parse(circuit: Circuit, proof_bytes: bytes, commitments: list[bytes], cap: int) -> Proof:
    """The proof, with its sizes checked against the circuit's."""
    if circuit.n_pad > cap:
        raise RefError("circuit exceeds the generator capacity")
    if len(commitments) != circuit.m:
        raise RefError("commitment count does not match the circuit")
    proof = parse_proof(proof_bytes)
    if len(proof.ipp_L) != circuit.n_pad.bit_length() - 1:
        raise RefError("wrong number of inner-product rounds")
    return proof


def terms(circuit: Circuit, proof_bytes: bytes, commitments: list[bytes], cap: int):
    """The proof's verification product as (g scalars, h scalars, B scalar,
    B_blinding scalar, [(scalar, point)] of the proof's own points)."""
    n1, n, m = circuit.n_gates, circuit.n_pad, circuit.m
    proof = parse(circuit, proof_bytes, commitments, cap)
    V = [_point(c) for c in commitments]
    ch = replay(circuit, proof, commitments)
    y, z, u, x, w, us, r = ch.y, ch.z, ch.u, ch.x, ch.w, ch.us, ch.r

    wL, wR, wO, wV, wc = circuit.flatten(z)
    y_inv = pow(y, L - 2, L)
    y_inv_pows = [1] * n
    for i in range(1, n):
        y_inv_pows[i] = y_inv_pows[i - 1] * y_inv % L
    # s_i = prod_j u_j^(+1 or -1), round 0 deciding the top bit of i
    s = [1]
    for uj in us:
        uj_inv = pow(uj, L - 2, L)
        s = [v for a in s for v in (a * uj_inv % L, a * uj % L)]
    a, b = proof.ipp_a, proof.ipp_b
    x2 = x * x % L
    g = [0] * n
    h = [0] * n
    delta = 0
    for i in range(n):
        f = 1 if i < n1 else u
        yi = y_inv_pows[i]
        g[i] = (a * s[i] * f - x * yi * wR[i]) % L
        h[i] = (b * s[n - 1 - i] * yi * f - yi * (x * wL[i] + wO[i]) + f) % L
        delta += yi * wR[i] * wL[i]
    delta %= L
    b_scalar = (w * (a * b - proof.t_x) + r * (proof.t_x - x2 * (delta + wc))) % L
    bb_scalar = (proof.e_blinding + r * proof.t_x_blinding) % L
    own = [((-r * x2 * wV[j]) % L, V[j]) for j in range(m)]
    for k, c in zip((1, 3, 4, 5, 6), proof.T):
        own.append(((-r * pow(x, k, L)) % L, _point(c)))
    own.append(((-x) % L, _point(proof.A_I1)))
    own.append(((-x2) % L, _point(proof.A_O1)))
    own.append(((-x2 * x) % L, _point(proof.S1)))
    for uj, lb, rb in zip(us, proof.ipp_L, proof.ipp_R):
        own.append(((-uj * uj) % L, _point(lb)))
        own.append(((-pow(uj, 2 * (L - 2), L)) % L, _point(rb)))
    return g, h, b_scalar, bb_scalar, own


def identity_many(products, cap: int, rng: np.random.Generator) -> bool:
    """True iff every product of `products` is the identity: each a function
    of no arguments that gives the `terms` of one product (g and h scalars
    against the first generators, B and B_blinding scalars, the product's own
    points).  A RefError from any makes the whole check False."""
    G, H, B, BB = generators(cap)
    g_all = [0] * cap
    h_all = [0] * cap
    b_all = bb_all = 0
    scalars, points = [], []
    try:
        for product in products:
            rho = int.from_bytes(rng.bytes(32), "little") % L or 1
            g, h, bs, bbs, own = product()
            for i, v in enumerate(g):
                g_all[i] = (g_all[i] + rho * v) % L
            for i, v in enumerate(h):
                h_all[i] = (h_all[i] + rho * v) % L
            b_all = (b_all + rho * bs) % L
            bb_all = (bb_all + rho * bbs) % L
            for sc, pt in own:
                scalars.append(rho * sc % L)
                points.append(pt)
    except RefError:
        return False
    total = msm.msm(g_all + h_all + [b_all, bb_all] + scalars,
                    G + H + [B, BB] + points)
    return msm.is_identity(total)


def verify_many(items, cap: int, rng: np.random.Generator) -> bool:
    """True iff every (circuit, proof bytes, commitments) of `items` verifies."""
    return identity_many([lambda it=it: terms(*it, cap) for it in items], cap, rng)


def verify(circuit: Circuit, proof_bytes: bytes, commitments: list[bytes], cap: int) -> bool:
    return verify_many([(circuit, proof_bytes, commitments)], cap, np.random.default_rng(0))
