"""The plain reference prover, as a check of a proof's bytes.

The configurations state that a proof's bytes follow from its statement,
its witness, the commitments' blindings and the 32-byte seed the prover is
handed: the `bulletproofs` crate's one-phase R1CS prover, whose blinding
draws come from a fork of its Merlin transcript keyed with every blinding
and the seed, read through numpy's `default_rng`, in this order: 3 blindings
of A_I1, A_O1 and S1; n_pad scalars of s_L, n_pad of s_R (each 252 bits, zero
from gate n1 on); the blindings of T_1, T_3, T_4, T_5, T_6.

`check` works out that proof again from those inputs alone and holds the
given bytes to it:

  * the commitments V_j = v_j B + gamma_j B_blinding, compressed, byte for byte;
  * the scalars t_x, t_x_blinding, e_blinding, a and b, byte for byte, from
    the reference's own witness, draws, polynomials and folds;
  * each point A_I1, A_O1, S1, T_k, L_j, R_j against its definition over the
    generators, as one product that must be the identity (returned as
    `verify.terms` are, to be checked under random weights with the
    verifier's products): Ristretto encodings are canonical, so equal points
    are equal bytes.

The challenges come from the transcript over the given points; where all of
those equal their definitions, the transcript is the reference's own.
"""

from __future__ import annotations

import numpy as np

from .circuits import Circuit
from .curve import L, ristretto_compress
from .generators import PedersenGens
from .verify import RefError, _point, parse, replay

MASK_252 = (1 << 252) - 1


def _draw(gen: np.random.Generator, count: int) -> list[int]:
    """`count` blinding scalars from one call: 32 bytes each, 252 bits kept."""
    raw = gen.bytes(32 * count)
    return [int.from_bytes(raw[32 * i:32 * i + 32], "little") & MASK_252
            for i in range(count)]


def _inner(a: list[int], b: list[int]) -> int:
    return sum(x * y for x, y in zip(a, b)) % L


def commitments(values: list[int], gammas: list[int]) -> list[bytes]:
    pc = PedersenGens.default()
    return [ristretto_compress(pc.commit(v % L, g % L)) for v, g in zip(values, gammas)]


def check(circuit: Circuit, gammas: list[int], seed: bytes, proof_bytes: bytes,
          comms: list[bytes], cap: int, weights: np.random.Generator):
    """(the parts of the proof that differ from the reference's, the product
    over its points that must be the identity, or None where a part already
    differs).  `circuit` is assigned (its committed values and wires);
    `weights` draws the weight of each point's definition."""
    a_L, a_R, a_O, v = circuit.assignment()
    n1, n, m = circuit.n_gates, circuit.n_pad, circuit.m
    differ = [f"V_{j}" for j, (mine, theirs)
              in enumerate(zip(commitments(v, gammas), comms)) if mine != theirs]
    if len(comms) != m:
        differ.append("commitment count")
    try:
        proof = parse(circuit, proof_bytes, comms, cap)
    except RefError as exc:
        return differ + [str(exc)], None
    if differ:
        return differ, None

    draws = {}

    def fork(t):
        builder = t.build_rng()
        for g in gammas:
            builder.rekey_with_witness_bytes(b"v_blinding", (g % L).to_bytes(32, "little"))
        gen = np.random.default_rng(list(builder.finalize(seed).fill_bytes(32)))
        draws["blind"] = _draw(gen, 3)
        draws["s_L"] = _draw(gen, n)[:n1] + [0] * (n - n1)
        draws["s_R"] = _draw(gen, n)[:n1] + [0] * (n - n1)
        draws["gen"] = gen

    ch = replay(circuit, proof, comms, fork)
    gen, (ib_I, ib_O, ib_S) = draws["gen"], draws["blind"]
    s_L, s_R = draws["s_L"], draws["s_R"]
    wL, wR, wO, wV, wc = circuit.flatten(ch.z)
    y_pows, y_inv_pows = [1] * n, [1] * n
    y_inv = pow(ch.y, L - 2, L)
    for i in range(1, n):
        y_pows[i] = y_pows[i - 1] * ch.y % L
        y_inv_pows[i] = y_inv_pows[i - 1] * y_inv % L

    # l(X) = l1 X + l2 X^2 + l3 X^3, r(X) = r0 + r1 X + r3 X^3
    l1 = [(a + yi * w) % L for a, yi, w in zip(a_L, y_inv_pows, wR)]
    l2, l3 = a_O, s_L
    r0 = [(w - yp) % L for w, yp in zip(wO, y_pows)]
    r1 = [(yp * a + w) % L for yp, a, w in zip(y_pows, a_R, wL)]
    r3 = [yp * s % L for yp, s in zip(y_pows, s_R)]
    t = {1: _inner(l1, r0),
         3: (_inner(l3, r0) + _inner(l2, r1)) % L,
         4: (_inner(l3, r1) + _inner(l1, r3)) % L,
         5: _inner(l2, r3),
         6: _inner(l3, r3)}
    t[2] = (_inner(l1, r1) + _inner(l2, r0)) % L
    tb = {k: _draw(gen, 1)[0] for k in (1, 3, 4, 5, 6)}
    tb[2] = sum(w * g for w, g in zip(wV, gammas)) % L

    x = ch.x
    xk = {k: pow(x, k, L) for k in range(1, 7)}
    mine = {
        "t_x": sum(t[k] * xk[k] for k in t) % L,
        "t_x_blinding": sum(tb[k] * xk[k] for k in tb) % L,
        "e_blinding": (ib_I * x + ib_O * xk[2] + ib_S * xk[3]) % L,
    }

    def weight() -> int:
        return int.from_bytes(weights.bytes(32), "little") % L or 1

    g_acc, h_acc = [0] * cap, [0] * cap
    b_acc = bb_acc = 0
    own = []
    # A_I1 = <a_L, G> + <a_R, H> + i B~, A_O1 = <a_O, G> + o B~, S1 = <s_L, G> + <s_R, H> + s B~
    for (g_vec, h_vec, blind, enc) in ((a_L, a_R, ib_I, proof.A_I1),
                                       (a_O, None, ib_O, proof.A_O1),
                                       (s_L, s_R, ib_S, proof.S1)):
        rho = weight()
        for i in range(n):
            g_acc[i] += rho * g_vec[i]
            if h_vec is not None:
                h_acc[i] += rho * h_vec[i]
        bb_acc += rho * blind
        own.append((-rho % L, _point(enc)))
    # T_k = t_k B + tau_k B~
    for k, enc in zip((1, 3, 4, 5, 6), proof.T):
        rho = weight()
        b_acc += rho * t[k]
        bb_acc += rho * tb[k]
        own.append((-rho % L, _point(enc)))

    # the inner-product argument over l(x), r(x), with G_i scaled by 1 below
    # n1 and u from n1 on, H_i by y^-i as well, and Q = w B
    a = [(l1[i] * x + l2[i] * xk[2] + l3[i] * xk[3]) % L for i in range(n)]
    b = [(r0[i] + r1[i] * x + r3[i] * xk[3]) % L for i in range(n)]
    gc = [1] * n1 + [ch.u] * (n - n1)  # G'_p = sum of gc[k] G_k over k = p mod size
    hc = [yi * f % L for yi, f in zip(y_inv_pows, gc)]
    size = n
    for u_j, L_enc, R_enc in zip(ch.us, proof.ipp_L, proof.ipp_R):
        h = size // 2
        c_L = _inner(a[:h], b[h:size])
        c_R = _inner(a[h:size], b[:h])
        rl, rr = weight(), weight()
        # L = <a_lo, G'_hi> + <b_hi, H'_lo> + c_L Q; R = <a_hi, G'_lo> + <b_lo, H'_hi> + c_R Q
        for k in range(n):
            p = k % size
            if p < h:
                g_acc[k] += rr * a[p + h] * gc[k]
                h_acc[k] += rl * b[p + h] * hc[k]
            else:
                g_acc[k] += rl * a[p - h] * gc[k]
                h_acc[k] += rr * b[p - h] * hc[k]
        g_acc = [v % L for v in g_acc]
        h_acc = [v % L for v in h_acc]
        b_acc += ch.w * (rl * c_L + rr * c_R)
        own.append((-rl % L, _point(L_enc)))
        own.append((-rr % L, _point(R_enc)))
        u_inv = pow(u_j, L - 2, L)
        a = [(a[i] * u_j + a[i + h] * u_inv) % L for i in range(h)]
        b = [(b[i] * u_inv + b[i + h] * u_j) % L for i in range(h)]
        for k in range(n):
            if k % size < h:
                gc[k] = gc[k] * u_inv % L
                hc[k] = hc[k] * u_j % L
            else:
                gc[k] = gc[k] * u_j % L
                hc[k] = hc[k] * u_inv % L
        size = h
    mine["ipp_a"], mine["ipp_b"] = a[0], b[0]
    differ = [name for name, value in mine.items() if getattr(proof, name) != value]
    if differ:
        return differ, None
    return [], ([v % L for v in g_acc], [v % L for v in h_acc], b_acc % L, bb_acc % L, own)
