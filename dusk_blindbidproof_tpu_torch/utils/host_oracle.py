"""Pure-Python (host) Bulletproofs R1CS prover/verifier oracle.

An independent, textbook implementation of the exact protocol the tensor
engine (models/bulletproofs.py) runs: same transcript schedule, same
blinding-RNG draws, same proof wire format, but computed entirely with
python ints and host Edwards points (utils/curve_host).

Purpose:

  * phase-by-phase differential debugging: every intermediate the tensor
    prover emits (A/T/L/R commitments, challenges, final scalars) can be
    compared against this oracle byte for byte on the same inputs;
  * independent verification: host_verify accepts the engine's proofs and
    the other way round, so a soundness bug in one implementation cannot
    hide in both.

Where the tensor prover uses the per-original-generator coefficient-vector
IPA (no generator folding, models/bulletproofs.py docstring), this oracle
folds generator point vectors explicitly, the textbook form: agreement
between the two is itself a check of the engine's coefficient mapping.

Deliberately unoptimized: scalar muls are double-and-add on host ints.  Use
only for small capacities (tests / debugging), not production proving.
It gives the same bytes as the JAX package's copy
(tests/test_torch_imports.py holds the two together on the CAP = 8 cube).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.bulletproofs import _sample_int, _sample_scalar_limbs
from ..models.proof_struct import R1CSProof
from ..models.r1cs import VarKind
from ..models.transcript_protocol import (
    IDENTITY_COMPRESSED,
    ProofError,
    append_point,
    append_scalar,
    challenge_scalar,
    innerproduct_domain_sep,
    r1cs_1phase_domain_sep,
    r1cs_domain_sep,
    validate_and_append_point,
)
from ..ops import limb
from . import curve_host as host
from .curve_host import L, EdwardsPoint, ristretto_compress, scalar_invert
from .generators import PedersenGens, cached_bp_gens
from .merlin import Transcript


def _limb_to_int(row) -> int:
    return limb.limbs_to_int(np.asarray(row)) % L


def _sample_scalars(rng: np.random.Generator, n: int) -> list[int]:
    """Identical byte consumption to bulletproofs._sample_scalar_limbs."""
    return [_limb_to_int(r) for r in _sample_scalar_limbs(rng, (n,))]


def _msm(points: list[EdwardsPoint], scalars: list[int]) -> EdwardsPoint:
    acc = EdwardsPoint.identity()
    for p, s in zip(points, scalars):
        acc = acc + p.scalar_mul(s % L)
    return acc


def flatten_constraints_host(artifact, z: int, publics: list[int]):
    """Host mirror of models.bulletproofs.flatten_constraints: returns
    (wL, wR, wO [n_pad], wV [m], wc) python ints with the same signs."""
    n_pad = artifact.padded_n()
    wL = [0] * n_pad
    wR = [0] * n_pad
    wO = [0] * n_pad
    wV = [0] * max(artifact.n_committed, 1)
    wc = 0

    def each(kind):
        qs, idxs, coeffs = artifact.entries[kind]
        for q, i, c in zip(qs, idxs, coeffs):
            yield int(q), int(i), int(c)

    for q, i, c in each(VarKind.MUL_LEFT):
        wL[i] = (wL[i] + pow(z, q + 1, L) * c) % L
    for q, i, c in each(VarKind.MUL_RIGHT):
        wR[i] = (wR[i] + pow(z, q + 1, L) * c) % L
    for q, i, c in each(VarKind.MUL_OUT):
        wO[i] = (wO[i] + pow(z, q + 1, L) * c) % L
    for q, i, c in each(VarKind.COMMITTED):
        wV[i] = (wV[i] - pow(z, q + 1, L) * c) % L
    for q, _i, c in each(VarKind.ONE):
        wc = (wc - pow(z, q + 1, L) * c) % L
    for q, i, c in each(VarKind.PUBLIC):
        wc = (wc - pow(z, q + 1, L) * c * publics[i]) % L
    return wL, wR, wO, wV, wc


@dataclass
class OracleTrace:
    """Every intermediate of one host proof, for differential comparison."""

    commitments: list[bytes] = None
    A_I1: bytes = None
    A_O1: bytes = None
    S1: bytes = None
    y: int = None
    z: int = None
    t: list = None  # t1..t6
    T_bytes: list = None
    u: int = None
    x: int = None
    t_x: int = None
    t_x_blinding: int = None
    e_blinding: int = None
    w: int = None
    l_vec: list = None
    r_vec: list = None
    L_bytes: list = None
    R_bytes: list = None
    u_js: list = None
    a: int = None
    b: int = None


def host_prove(
    artifact,
    transcript: Transcript,
    v: list[int],
    v_blinding: list[int],
    a_L: list[int],
    a_R: list[int],
    a_O: list[int],
    publics: list[int],
    cap: int,
    seed: bytes = b"\x00" * 32,
    skip_commit: bool = False,
) -> tuple[R1CSProof, OracleTrace]:
    """Mirror of models.bulletproofs.Prover for one proof (B = 1).

    `artifact` is a `models.r1cs.CircuitArtifact`.  The transcript must
    be fresh (the caller's protocol label only); this function performs the
    r1cs domain separator, V appends, and the whole schedule, exactly as
    Prover.__init__ + commit_batch + prove do.
    """
    tr = OracleTrace()
    bp = cached_bp_gens(cap)
    pc = PedersenGens.default()
    G, H = bp.share(0)
    n1 = artifact.n_gates
    n_pad = artifact.padded_n()
    m = artifact.n_committed
    assert n_pad <= cap

    t = transcript
    r1cs_domain_sep(t)
    tr.commitments = []
    for j in range(m):
        c = ristretto_compress(pc.commit(v[j] % L, v_blinding[j] % L))
        append_point(t, b"V", c)
        tr.commitments.append(c)
    t.append_u64(b"m", m)

    # transcript-bound blinding RNG — identical draws to the device prover
    keyed = t.build_rng()
    for j in range(m):
        keyed = keyed.rekey_with_witness_bytes(
            b"v_blinding",
            bytes(limb.limbs_to_bytes_le(limb.int_to_limbs(v_blinding[j] % L))),
        )
    rng = np.random.default_rng(list(keyed.finalize(seed).fill_bytes(32)))

    i_blind = _sample_scalars(rng, 3)
    s_L = _sample_scalars(rng, n_pad)
    s_R = _sample_scalars(rng, n_pad)
    for i in range(n1, n_pad):
        s_L[i] = 0
        s_R[i] = 0

    a_L = [x % L for x in a_L] + [0] * (n_pad - len(a_L))
    a_R = [x % L for x in a_R] + [0] * (n_pad - len(a_R))
    a_O = [x % L for x in a_O] + [0] * (n_pad - len(a_O))

    A_I = _msm(G[:n_pad], a_L) + _msm(H[:n_pad], a_R) + pc.B_blinding.scalar_mul(i_blind[0])
    A_O = _msm(G[:n_pad], a_O) + pc.B_blinding.scalar_mul(i_blind[1])
    S = _msm(G[:n_pad], s_L) + _msm(H[:n_pad], s_R) + pc.B_blinding.scalar_mul(i_blind[2])
    tr.A_I1, tr.A_O1, tr.S1 = (
        ristretto_compress(A_I),
        ristretto_compress(A_O),
        ristretto_compress(S),
    )
    append_point(t, b"A_I1", tr.A_I1)
    append_point(t, b"A_O1", tr.A_O1)
    append_point(t, b"S1", tr.S1)
    r1cs_1phase_domain_sep(t)
    append_point(t, b"A_I2", IDENTITY_COMPRESSED)
    append_point(t, b"A_O2", IDENTITY_COMPRESSED)
    append_point(t, b"S2", IDENTITY_COMPRESSED)
    y = challenge_scalar(t, b"y")
    z = challenge_scalar(t, b"z")
    tr.y, tr.z = y, z

    wL, wR, wO, wV, wc = flatten_constraints_host(artifact, z, publics)
    y_inv = scalar_invert(y)
    y_pows = [pow(y, i, L) for i in range(n_pad)]
    y_inv_pows = [pow(y_inv, i, L) for i in range(n_pad)]

    l1 = [(a_L[i] + y_inv_pows[i] * wR[i]) % L for i in range(n_pad)]
    l2 = list(a_O)
    l3 = list(s_L)
    r0 = [(wO[i] - y_pows[i]) % L for i in range(n_pad)]
    r1 = [(y_pows[i] * a_R[i] + wL[i]) % L for i in range(n_pad)]
    r3 = [(y_pows[i] * s_R[i]) % L for i in range(n_pad)]

    def inner(u_, v_):
        return sum(ui * vi for ui, vi in zip(u_, v_)) % L

    t1 = inner(l1, r0)
    t2 = (inner(l1, r1) + inner(l2, r0)) % L
    t3 = (inner(l3, r0) + inner(l2, r1)) % L
    t4 = (inner(l3, r1) + inner(l1, r3)) % L
    t5 = inner(l2, r3)
    t6 = inner(l3, r3)
    tr.t = [t1, t2, t3, t4, t5, t6]

    tb = {}
    for k in (1, 3, 4, 5, 6):
        tb[k] = _sample_int(rng)
    tb[2] = sum(wV[j] * (v_blinding[j] % L) for j in range(m)) % L

    T_bytes = []
    tvals = {1: t1, 3: t3, 4: t4, 5: t5, 6: t6}
    for k in (1, 3, 4, 5, 6):
        T_bytes.append(ristretto_compress(pc.commit(tvals[k], tb[k])))
    tr.T_bytes = T_bytes
    for label, c in zip([b"T_1", b"T_3", b"T_4", b"T_5", b"T_6"], T_bytes):
        append_point(t, label, c)
    u = challenge_scalar(t, b"u")
    x = challenge_scalar(t, b"x")
    tr.u, tr.x = u, x

    t_int = [t1, t2, t3, t4, t5, t6]
    t_x = sum(t_int[k - 1] * pow(x, k, L) for k in range(1, 7)) % L
    t_x_blinding = sum(tb[k] * pow(x, k, L) for k in (1, 2, 3, 4, 5, 6)) % L
    e_blinding = (
        i_blind[0] * x + i_blind[1] * x * x + i_blind[2] * pow(x, 3, L)
    ) % L
    tr.t_x, tr.t_x_blinding, tr.e_blinding = t_x, t_x_blinding, e_blinding
    append_scalar(t, b"t_x", t_x)
    append_scalar(t, b"t_x_blinding", t_x_blinding)
    append_scalar(t, b"e_blinding", e_blinding)
    w = challenge_scalar(t, b"w")
    tr.w = w

    l_vec = [
        (l1[i] * x + l2[i] * x * x + l3[i] * pow(x, 3, L)) % L
        for i in range(n_pad)
    ]
    r_vec = [
        (r0[i] + r1[i] * x + r3[i] * pow(x, 3, L)) % L for i in range(n_pad)
    ]
    tr.l_vec, tr.r_vec = list(l_vec), list(r_vec)

    # ---- inner-product argument (textbook: fold generator point vectors) --
    innerproduct_domain_sep(t, n_pad)
    Q = pc.B.scalar_mul(w)
    f = [1 if i < n1 else u for i in range(n_pad)]
    Ghat = [G[i].scalar_mul(f[i]) for i in range(n_pad)]
    Hhat = [H[i].scalar_mul(y_inv_pows[i] * f[i] % L) for i in range(n_pad)]
    a = list(l_vec)
    b = list(r_vec)
    L_bytes, R_bytes, u_js = [], [], []
    n_prime = n_pad
    while n_prime > 1:
        h = n_prime // 2
        c_L = sum(a[i] * b[h + i] for i in range(h)) % L
        c_R = sum(a[h + i] * b[i] for i in range(h)) % L
        L_pt = (
            _msm(Ghat[h : 2 * h], a[:h])
            + _msm(Hhat[:h], b[h : 2 * h])
            + Q.scalar_mul(c_L)
        )
        R_pt = (
            _msm(Ghat[:h], a[h : 2 * h])
            + _msm(Hhat[h : 2 * h], b[:h])
            + Q.scalar_mul(c_R)
        )
        lb, rb = ristretto_compress(L_pt), ristretto_compress(R_pt)
        append_point(t, b"L", lb)
        append_point(t, b"R", rb)
        L_bytes.append(lb)
        R_bytes.append(rb)
        uj = challenge_scalar(t, b"u")
        uji = scalar_invert(uj)
        u_js.append(uj)
        a = [(a[i] * uj + a[h + i] * uji) % L for i in range(h)]
        b = [(b[i] * uji + b[h + i] * uj) % L for i in range(h)]
        Ghat = [Ghat[i].scalar_mul(uji) + Ghat[h + i].scalar_mul(uj) for i in range(h)]
        Hhat = [Hhat[i].scalar_mul(uj) + Hhat[h + i].scalar_mul(uji) for i in range(h)]
        n_prime = h
    tr.L_bytes, tr.R_bytes, tr.u_js = L_bytes, R_bytes, u_js
    tr.a, tr.b = a[0], b[0]

    proof = R1CSProof(
        A_I1=tr.A_I1, A_O1=tr.A_O1, S1=tr.S1,
        A_I2=IDENTITY_COMPRESSED, A_O2=IDENTITY_COMPRESSED,
        S2=IDENTITY_COMPRESSED,
        T_1=T_bytes[0], T_3=T_bytes[1], T_4=T_bytes[2], T_5=T_bytes[3],
        T_6=T_bytes[4],
        t_x=t_x, t_x_blinding=t_x_blinding, e_blinding=e_blinding,
        ipp_L=L_bytes, ipp_R=R_bytes, ipp_a=a[0], ipp_b=b[0],
    )
    return proof, tr


def host_verify(
    artifact,
    transcript: Transcript,
    proof: R1CSProof,
    commitments: list[bytes],
    publics: list[int],
    cap: int,
) -> bool:
    """Host mirror of Verifier.verify for one proof: replays the transcript
    and evaluates the single verification MSM with host points."""
    bp = cached_bp_gens(cap)
    pc = PedersenGens.default()
    G, H = bp.share(0)
    n1 = artifact.n_gates
    n_pad = artifact.padded_n()
    m = artifact.n_committed
    rounds = n_pad.bit_length() - 1
    if len(proof.ipp_L) != rounds:
        raise ProofError("wrong number of IPA rounds")

    t = transcript
    r1cs_domain_sep(t)
    V_pts = []
    for c in commitments:
        pt = host.ristretto_decompress(c)
        if pt is None:
            raise ProofError("invalid commitment encoding")
        V_pts.append(pt)
        append_point(t, b"V", c)
    t.append_u64(b"m", m)
    validate_and_append_point(t, b"A_I1", proof.A_I1)
    validate_and_append_point(t, b"A_O1", proof.A_O1)
    validate_and_append_point(t, b"S1", proof.S1)
    r1cs_1phase_domain_sep(t)
    append_point(t, b"A_I2", proof.A_I2)
    append_point(t, b"A_O2", proof.A_O2)
    append_point(t, b"S2", proof.S2)
    y = challenge_scalar(t, b"y")
    z = challenge_scalar(t, b"z")
    for label, c in zip(
        [b"T_1", b"T_3", b"T_4", b"T_5", b"T_6"],
        [proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6],
    ):
        append_point(t, label, c)
    u = challenge_scalar(t, b"u")
    x = challenge_scalar(t, b"x")
    append_scalar(t, b"t_x", proof.t_x)
    append_scalar(t, b"t_x_blinding", proof.t_x_blinding)
    append_scalar(t, b"e_blinding", proof.e_blinding)
    w = challenge_scalar(t, b"w")
    innerproduct_domain_sep(t, n_pad)
    u_js = []
    for lb, rb in zip(proof.ipp_L, proof.ipp_R):
        append_point(t, b"L", lb)
        append_point(t, b"R", rb)
        u_js.append(challenge_scalar(t, b"u"))
    r = challenge_scalar(t, b"r")

    wL, wR, wO, wV, wc = flatten_constraints_host(artifact, z, publics)
    y_inv = scalar_invert(y)
    y_inv_pows = [pow(y_inv, i, L) for i in range(n_pad)]

    # s vector from IPA challenges (MSB-first rounds)
    s = []
    for i in range(n_pad):
        acc = 1
        for j in range(rounds):
            bit = (i >> (rounds - 1 - j)) & 1
            acc = acc * (u_js[j] if bit else scalar_invert(u_js[j])) % L
        s.append(acc)
    s_inv = s[::-1]
    f = [1 if i < n1 else u for i in range(n_pad)]
    a, b = proof.ipp_a % L, proof.ipp_b % L
    x2 = x * x % L

    g_scalars = [
        (a * s[i] * f[i] - x * y_inv_pows[i] * wR[i]) % L for i in range(n_pad)
    ]
    h_scalars = [
        (
            b * s_inv[i] * y_inv_pows[i] * f[i]
            - y_inv_pows[i] * (x * wL[i] + wO[i])
            + f[i]
        )
        % L
        for i in range(n_pad)
    ]
    delta = sum(y_inv_pows[i] * wR[i] * wL[i] for i in range(n_pad)) % L
    b_scalar = (
        w * (a * b - proof.t_x)
        + r * (proof.t_x - x2 * (delta + wc))
    ) % L
    bblind_scalar = (proof.e_blinding + r * proof.t_x_blinding) % L

    total = _msm(G[:n_pad], g_scalars) + _msm(H[:n_pad], h_scalars)
    total = total + pc.B.scalar_mul(b_scalar) + pc.B_blinding.scalar_mul(bblind_scalar)
    for j in range(m):
        total = total + V_pts[j].scalar_mul((-r * x2 * wV[j]) % L)
    T_pts = {}
    for k, tb in zip((1, 3, 4, 5, 6),
                     (proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6)):
        pt = host.ristretto_decompress(tb)
        if pt is None:
            raise ProofError("invalid T encoding")
        total = total + pt.scalar_mul((-r * pow(x, k, L)) % L)
    for enc, sc in (
        (proof.A_I1, (-x) % L),
        (proof.A_O1, (-x2) % L),
        (proof.S1, (-x2 * x) % L),
    ):
        pt = host.ristretto_decompress(enc)
        if pt is None:
            raise ProofError("invalid A/S encoding")
        total = total + pt.scalar_mul(sc)
    if not proof.missing_phase2():
        for enc, sc in (
            (proof.A_I2, (-u * x) % L),
            (proof.A_O2, (-u * x2) % L),
            (proof.S2, (-u * x2 * x) % L),
        ):
            pt = host.ristretto_decompress(enc)
            if pt is None:
                raise ProofError("invalid phase-2 encoding")
            total = total + pt.scalar_mul(sc)
    for uj, lb, rb in zip(u_js, proof.ipp_L, proof.ipp_R):
        L_pt = host.ristretto_decompress(lb)
        R_pt = host.ristretto_decompress(rb)
        if L_pt is None or R_pt is None:
            raise ProofError("invalid point encoding in proof")
        total = total + L_pt.scalar_mul((-uj * uj) % L)
        total = total + R_pt.scalar_mul((-scalar_invert(uj) ** 2) % L)

    return total.ristretto_eq(EdwardsPoint.identity())
