"""BlindBid circuit gadgets.

Behavioral port of /root/reference/src/gadgets.rs (the whole circuit):
  * proof_gadget    (gadgets.rs:6-34)
  * mimc_gadget     (gadgets.rs:37-68)  — MiMC-x^7, 90 rounds, returns x+key
  * score_gadget    (gadgets.rs:70-86)  — y*y_inv = 1 and q = d*y_inv
  * one_of_many     (gadgets.rs:88-132) — booleanity + prefix-sum + membership
  * boolean_gadget  (gadgets.rs:134-140)

Constraint budget must match SURVEY.md §8.2: 1442 + 3L multiplication gates,
with the exact same gate/constraint ORDER as the reference (the constraint
order fixes the z-power each constraint receives, which is
challenge-relevant).  One gadget, two interpretations: runs on ProverCS and
VerifierCS identically.
"""

from __future__ import annotations

from ..utils.curve_host import L
from .r1cs import LC, ConstraintSystem, Variable

MIMC_ROUNDS = 90


def blindbid_gates(list_len: int) -> int:
    """n1 of the circuit of `list_len` bids, from the length alone: four
    MiMC calls of four gates a round, the score gadget's two gates and three
    gates a bid (booleanity and two membership gates), 1442 + 3L."""
    if list_len < 1:
        raise ValueError("empty bid list")
    return 4 * 4 * MIMC_ROUNDS + 2 + 3 * list_len


def blindbid_n_pad(list_len: int) -> int:
    """The next power of two at or above `blindbid_gates(list_len)`: the
    gate count CompiledCircuit.compile pads the circuit to."""
    return 1 << (blindbid_gates(list_len) - 1).bit_length()


def mimc_gadget(cs: ConstraintSystem, left, right, constants) -> LC:
    """x_{i+1} = (x_i + key + c_i)^7 via gates a^2, a^3, a^4, a^7; returns
    final x + key (gadgets.rs:37-68)."""
    assert len(constants) == MIMC_ROUNDS
    x = LC.of(left)
    key = LC.of(right)
    for i in range(MIMC_ROUNDS):
        a = x + key + constants[i]
        _, _, a_2 = cs.multiply(a, a)
        _, _, a_3 = cs.multiply(a_2, a)
        _, _, a_4 = cs.multiply(a_2, a_2)
        _, _, a_7 = cs.multiply(a_4, a_3)
        x = LC.of(a_7)
    return x + key


def score_gadget(cs: ConstraintSystem, d, y, y_inv, q) -> None:
    """y*y_inv = 1 and q = d*y_inv (gadgets.rs:70-86)."""
    _, _, one_var = cs.multiply(y, y_inv)
    cs.constrain(LC.of(one_var) - 1)
    _, _, q_var = cs.multiply(d, y_inv)
    cs.constrain(LC.of(q) - q_var)


def boolean_gadget(cs: ConstraintSystem, a) -> None:
    """a * (1 - a) = 0 (gadgets.rs:134-140)."""
    a = LC.of(a)
    _, _, c_var = cs.multiply(a, LC.of(1) - a)
    cs.constrain(LC.of(c_var))


def one_of_many_gadget(cs: ConstraintSystem, x, toggle, items) -> None:
    """Membership of x in `items` via a committed one-hot toggle vector
    (gadgets.rs:88-132), preserving the reference's exact constraint order:
    booleanity gates first, then the (redundant) prefix-sum chain, then
    sum-of-toggles = 1, then per-slot membership gates."""
    toggle_len = len(toggle)
    x = LC.of(x)

    for t in toggle:
        boolean_gadget(cs, t)

    toggle_sum: list[LC] = [LC.of(toggle[0])]
    for i in range(1, toggle_len):
        toggle_sum.append(toggle_sum[i - 1] + toggle[i])

    # the reference re-assigns toggle_sum[i] and constrains
    # prev + curr - curr_sum (identically zero, but transcript... constraint
    # order matters for z powers) — gadgets.rs:112-123
    for i in range(1, toggle_len):
        prev = toggle_sum[i - 1]
        curr = LC.of(toggle[i])
        curr_sum = toggle_sum[i]
        cs.constrain(prev + curr - curr_sum)
    cs.constrain(toggle_sum[toggle_len - 1] - 1)

    for i in range(toggle_len):
        _, _, left = cs.multiply(items[i], toggle[i])
        _, _, right = cs.multiply(toggle[i], x)
        cs.constrain(LC.of(left) - right)


def proof_gadget(
    cs: ConstraintSystem,
    d,
    k,
    y_inv,
    q,
    z_img,
    seed,
    constants,
    toggle: list[Variable],
    items,
) -> None:
    """The full BlindBid circuit (gadgets.rs:6-34):
    m = MiMC(k, 0); x = MiMC(d, m); x ∈ items; y = MiMC(seed, x);
    z = MiMC(seed, m); z == z_img; y*y_inv = 1; q = d*y_inv."""
    assert len(constants) == MIMC_ROUNDS
    m = mimc_gadget(cs, k, LC.of(0), constants)
    x = mimc_gadget(cs, d, m, constants)
    one_of_many_gadget(cs, x, toggle, items)
    y = mimc_gadget(cs, seed, x, constants)
    z = mimc_gadget(cs, seed, m, constants)
    cs.constrain(LC.of(z_img) - z)
    score_gadget(cs, d, y, y_inv, q)


def mimc_hash(left: int, right: int, constants) -> int:
    """Plain host evaluation of the MiMC permutation (for witness prep:
    computing y, y_inv, q, z_img inputs the way a client would)."""
    x, key = left % L, right % L
    for c in constants:
        a = (x + key + c) % L
        x = pow(a, 7, L)
    return (x + key) % L
