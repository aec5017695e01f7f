"""The circuits the benchmark's cells prove, synthesized by the plain reference.

A small R1CS builder (linear combinations of gate wires and committed
values, constant terms on ONE) and the two circuits:

  * `blindbid(pub_list, q, z_img, seed)`: the Dusk BlindBid circuit with its
    public inputs folded in as constants, as the original Rust gadget has
    them: m = MiMC(k, 0); x = MiMC(d, m); x is one of the list through a
    committed one-hot toggle vector; y = MiMC(seed, x); z = MiMC(seed, m);
    z == z_img; y * y_inv = 1; q = d * y_inv.  Committed order [d, k, y,
    y_inv, toggles...].
  * `chain(n_pad)`: one committed input v0 and n_pad - 1 gates
    w_{i+1} = w_i * w_i (the squaring chain of the generic prover's bench).

`Circuit.flatten(z)` gives the verifier's weight vectors against challenge
powers z^(q+1): <wL,aL> + <wR,aR> + <wO,aO> = <wV,v> + wc.  Given the
committed values (`witness=` / `v0=`), the same synthesis also assigns every
gate's wires (`Circuit.assignment`), which the reference prover's check needs.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

from .curve import L, scalar_from_bytes_mod_order_wide, scalar_to_bytes

MIMC_ROUNDS = 90
BLINDBID_LABEL = b"BlindBidProofGadget"
CHAIN_LABEL = b"ipa-bench"

ONE, COMMITTED, LEFT, RIGHT, OUT = range(5)


@lru_cache(maxsize=1)
def mimc_constants() -> tuple[int, ...]:
    """90 constants: a SHA-512 chain from b"blind bid", each reduced wide mod
    l, the next hash taken over the previous constant's 32 bytes."""
    out = []
    h = hashlib.sha512(b"blind bid").digest()
    for _ in range(MIMC_ROUNDS):
        c = scalar_from_bytes_mod_order_wide(h)
        out.append(c)
        h = hashlib.sha512(scalar_to_bytes(c)).digest()
    return tuple(out)


def mimc_hash(left: int, right: int) -> int:
    x, key = left % L, right % L
    for c in mimc_constants():
        x = pow((x + key + c) % L, 7, L)
    return (x + key) % L


def _lc(x) -> dict:
    """A linear combination {(kind, index): coeff}; an int is a constant."""
    if isinstance(x, dict):
        return x
    x %= L
    return {(ONE, 0): x} if x else {}


def _add(a, b, k: int = 1) -> dict:
    """a + k b."""
    out = dict(_lc(a))
    for var, c in _lc(b).items():
        nc = (out.get(var, 0) + k * c) % L
        if nc:
            out[var] = nc
        else:
            out.pop(var, None)
    return out


class Circuit:
    def __init__(self, label: bytes, assign: bool = False):
        self.label = label
        self.n_gates = 0
        self.m = 0
        self.constraints: list[dict] = []
        # with `assign`: the value of every variable, {(kind, index): value}
        self.values: dict | None = {} if assign else None

    def commit(self, value: int | None = None) -> dict:
        self.m += 1
        var = (COMMITTED, self.m - 1)
        if self.values is not None:
            self.values[var] = value % L
        return {var: 1}

    def value(self, lc) -> int:
        return sum(c * (1 if kind == ONE else self.values[(kind, i)])
                   for (kind, i), c in _lc(lc).items()) % L

    def multiply(self, left, right) -> dict:
        """One gate: constrains its left and right wires to the given
        combinations; returns its output wire."""
        i = self.n_gates
        self.n_gates += 1
        if self.values is not None:
            lv, rv = self.value(left), self.value(right)
            self.values.update({(LEFT, i): lv, (RIGHT, i): rv, (OUT, i): lv * rv % L})
        self.constrain(_add(left, {(LEFT, i): 1}, -1))
        self.constrain(_add(right, {(RIGHT, i): 1}, -1))
        return {(OUT, i): 1}

    def assignment(self):
        """(a_L, a_R, a_O over n_pad gates, zero past the last; v over the
        m committed values) of an assigned circuit."""
        wires = [[self.values.get((kind, i), 0) for i in range(self.n_pad)]
                 for kind in (LEFT, RIGHT, OUT)]
        return (*wires, [self.values[(COMMITTED, j)] for j in range(self.m)])

    def constrain(self, lc) -> None:
        self.constraints.append(_lc(lc))

    @property
    def n_pad(self) -> int:
        return 1 << (max(self.n_gates, 1) - 1).bit_length()

    def flatten(self, z: int):
        n = self.n_pad
        wL, wR, wO = [0] * n, [0] * n, [0] * n
        wV = [0] * max(self.m, 1)
        wc = 0
        zq = z
        for lc in self.constraints:
            for (kind, i), c in lc.items():
                t = zq * c % L
                if kind == LEFT:
                    wL[i] = (wL[i] + t) % L
                elif kind == RIGHT:
                    wR[i] = (wR[i] + t) % L
                elif kind == OUT:
                    wO[i] = (wO[i] + t) % L
                elif kind == COMMITTED:
                    wV[i] = (wV[i] - t) % L
                else:
                    wc = (wc - t) % L
            zq = zq * z % L
        return wL, wR, wO, wV, wc


def _mimc_gadget(cs: Circuit, left, right):
    x, key = _lc(left), _lc(right)
    for c in mimc_constants():
        a = _add(_add(x, key), c)
        a2 = cs.multiply(a, a)
        a3 = cs.multiply(a2, a)
        a4 = cs.multiply(a2, a2)
        x = cs.multiply(a4, a3)
    return _add(x, key)


def blindbid(pub_list: list[int], q: int, z_img: int, seed: int,
             witness: dict | None = None) -> Circuit:
    """`witness`: a bidder (`bidder`) whose values are committed and assigned."""
    cs = Circuit(BLINDBID_LABEL, assign=witness is not None)
    secrets = [None] * (4 + len(pub_list))
    if witness is not None:
        secrets = [witness[key] for key in ("d", "k", "y", "y_inv")]
        secrets += [int(i == witness["toggle"]) for i in range(len(pub_list))]
    d, k, _y, y_inv = (cs.commit(v) for v in secrets[:4])
    toggles = [cs.commit(v) for v in secrets[4:]]
    m = _mimc_gadget(cs, k, 0)
    x = _mimc_gadget(cs, d, m)
    # one of many: booleanity, the (redundant) prefix sums, sum = 1, membership
    for t in toggles:
        cs.constrain(cs.multiply(t, _add(1, t, -1)))
    sums = [toggles[0]]
    for t in toggles[1:]:
        sums.append(_add(sums[-1], t))
    for i in range(1, len(toggles)):
        cs.constrain(_add(_add(sums[i - 1], toggles[i]), sums[i], -1))
    cs.constrain(_add(sums[-1], 1, -1))
    for item, t in zip(pub_list, toggles):
        left = cs.multiply(item, t)
        right = cs.multiply(t, x)
        cs.constrain(_add(left, right, -1))
    y = _mimc_gadget(cs, seed, x)
    z = _mimc_gadget(cs, seed, m)
    cs.constrain(_add(z_img, z, -1))
    # score: y * y_inv = 1 and q = d * y_inv
    cs.constrain(_add(cs.multiply(y, y_inv), 1, -1))
    cs.constrain(_add(q, cs.multiply(d, y_inv), -1))
    return cs


def chain(n_pad: int, v0: int | None = None) -> Circuit:
    """`v0`: the committed input, assigned through the chain."""
    cs = Circuit(CHAIN_LABEL, assign=v0 is not None)
    cur = cs.commit(v0)
    for _ in range(n_pad - 1):
        cur = cs.multiply(cur, cur)
    return cs


def bidder(d: int, k: int, seed: int, others: list[int], pos: int) -> dict:
    """What a bidder's client derives before it asks for a proof, the way the
    canonical Go client does: its own bid x is inserted at `pos` into the
    list; y, y_inv, the score q and z_img follow from MiMC."""
    m = mimc_hash(k, 0)
    x = mimc_hash(d, m)
    y = mimc_hash(seed, x)
    z = mimc_hash(seed, m)
    y_inv = pow(y, L - 2, L)
    pub_list = list(others)
    pub_list.insert(pos, x)
    return dict(d=d, k=k, y=y, y_inv=y_inv, q=d * y_inv % L, z_img=z, seed=seed,
                pub_list=pub_list, toggle=pos)
