"""R1CS constraint system builder (the `ConstraintSystem` trait equivalent).

Mirrors the API property the reference depends on most (SURVEY.md §3.4):
*one gadget definition, two interpretations* — the same circuit function runs
against a witness-carrying ProverCS and a shape-only VerifierCS
(/root/reference/src/gadgets.rs:6 `proof_gadget<CS: ConstraintSystem>`;
called identically from proof.rs:74-85 and verify.rs:74-85).

TPU-first twist: synthesis happens once on the host per circuit *shape* and
is compiled to a CircuitArtifact — static sparse weight matrices (COO index /
coefficient arrays) that device programs consume: flattening the constraints
against challenge powers z^q becomes a gather-multiply-segment-add over limb
vectors instead of a per-request Python walk (the reference re-synthesizes
the gadget on every request, SURVEY.md §8.5 quirk 5).

Variables carry python-int scalar coefficients mod L; witness evaluation is
exact host integer arithmetic (the per-gate work is trivial next to the
device MSMs; a device witness program is a later optimization).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from ..utils.curve_host import L


class VarKind(IntEnum):
    ONE = 0
    COMMITTED = 1
    MUL_LEFT = 2
    MUL_RIGHT = 3
    MUL_OUT = 4
    # PUBLIC is a TPU-first extension: the reference bakes public inputs
    # (q, z_img, seed, pub_list) into LC constants, which would make the
    # compiled circuit request-specific.  Treating them as indexed symbols
    # keeps the artifact static per circuit shape; the flattened constant
    # term becomes wc + <wP, publics>, evaluated on device per request —
    # mathematically identical to the reference's constant-folding.
    PUBLIC = 5


@dataclass(frozen=True)
class Variable:
    kind: VarKind
    index: int

    def __add__(self, other):
        return LC.of(self) + other

    def __radd__(self, other):
        return LC.of(self) + other

    def __sub__(self, other):
        return LC.of(self) - other

    def __rsub__(self, other):
        return LC.of(other) - self

    def __mul__(self, k: int):
        return LC.of(self) * k

    __rmul__ = __mul__

    def __neg__(self):
        return LC.of(self) * (L - 1)


ONE = Variable(VarKind.ONE, 0)


class LC:
    """Linear combination: {Variable: coeff mod L}."""

    __slots__ = ("terms",)

    def __init__(self, terms: dict | None = None):
        self.terms = terms or {}

    @staticmethod
    def of(x) -> "LC":
        if isinstance(x, LC):
            return x
        if isinstance(x, Variable):
            return LC({x: 1})
        if isinstance(x, int):
            return LC({ONE: x % L}) if x % L else LC()
        raise TypeError(f"cannot build LC from {type(x)}")

    def __add__(self, other):
        other = LC.of(other)
        out = dict(self.terms)
        for v, c in other.terms.items():
            nc = (out.get(v, 0) + c) % L
            if nc:
                out[v] = nc
            else:
                out.pop(v, None)
        return LC(out)

    __radd__ = __add__

    def __sub__(self, other):
        return self + (LC.of(other) * (L - 1))

    def __rsub__(self, other):
        return LC.of(other) + (self * (L - 1))

    def __mul__(self, k: int):
        k = k % L
        return LC({v: (c * k) % L for v, c in self.terms.items()} if k else {})

    __rmul__ = __mul__

    def __neg__(self):
        return self * (L - 1)


@dataclass
class CircuitArtifact:
    """Static circuit shape compiled from one synthesis run.

    COO entries per weight matrix: (constraint q, var index i, coeff) with the
    sign conventions of the flattening (SURVEY.md §3.4): for challenge powers
    zq[q] = z^(q+1),
        wL[i] = sum z^(q+1) * coeff   over MUL_LEFT entries, likewise wR, wO;
        wV[j] = -sum z^(q+1) * coeff  over COMMITTED entries;
        wc    = -sum z^(q+1) * coeff  over ONE entries,
    so that the flattened constraint reads
        <wL,aL> + <wR,aR> + <wO,aO> = <wV,v> + wc.
    """

    n_gates: int
    n_constraints: int
    n_committed: int
    n_public: int
    entries: dict = field(default_factory=dict)  # kind -> (q_idx, var_idx, coeff)

    def padded_n(self) -> int:
        n = max(self.n_gates, 1)
        return 1 << (n - 1).bit_length()


class ConstraintSystem:
    """Base: records constraint structure; subclasses add witness handling."""

    def __init__(self):
        self.num_gates = 0
        self.num_committed = 0
        self.num_public = 0
        self.constraints: list[LC] = []

    # -- the reference trait surface (gadgets.rs usage) ---------------------
    def multiply(self, left, right) -> tuple[Variable, Variable, Variable]:
        left, right = LC.of(left), LC.of(right)
        i = self.num_gates
        self.num_gates += 1
        l_var = Variable(VarKind.MUL_LEFT, i)
        r_var = Variable(VarKind.MUL_RIGHT, i)
        o_var = Variable(VarKind.MUL_OUT, i)
        self._assign_gate(i, left, right)
        # bind the gate wires to the linear combinations
        self.constrain(left - l_var)
        self.constrain(right - r_var)
        return l_var, r_var, o_var

    def constrain(self, lc) -> None:
        self.constraints.append(LC.of(lc))

    # -- hooks ---------------------------------------------------------------
    def _assign_gate(self, i: int, left: LC, right: LC) -> None:
        pass

    def commit_var(self) -> Variable:
        v = Variable(VarKind.COMMITTED, self.num_committed)
        self.num_committed += 1
        return v

    def public_var(self) -> Variable:
        v = Variable(VarKind.PUBLIC, self.num_public)
        self.num_public += 1
        return v

    # -- compilation ----------------------------------------------------------
    def artifact(self) -> CircuitArtifact:
        ent = {kind: ([], [], []) for kind in VarKind}
        for q, lc in enumerate(self.constraints):
            for v, c in lc.terms.items():
                qs, idxs, coeffs = ent[v.kind]
                qs.append(q)
                idxs.append(v.index)
                coeffs.append(c)
        entries = {
            kind: (
                np.asarray(qs, dtype=np.int32),
                np.asarray(idxs, dtype=np.int32),
                list(coeffs),  # python ints mod L (converted to limbs lazily)
            )
            for kind, (qs, idxs, coeffs) in ent.items()
        }
        return CircuitArtifact(
            n_gates=self.num_gates,
            n_constraints=len(self.constraints),
            n_committed=self.num_committed,
            n_public=self.num_public,
            entries=entries,
        )


class VerifierCS(ConstraintSystem):
    """Shape-only interpretation (the reference's Verifier commit path,
    /root/reference/src/blindbid/verify.rs:54-64)."""


class ProverCS(ConstraintSystem):
    """Witness-carrying interpretation: evaluates every LC over the current
    assignment exactly (python ints mod L) while recording structure."""

    def __init__(self, committed_values: list[int], public_values: list[int] = ()):
        super().__init__()
        self.v = [x % L for x in committed_values]
        self.pub = [x % L for x in public_values]
        self.num_committed = len(self.v)
        self.num_public = len(self.pub)
        self.a_L: list[int] = []
        self.a_R: list[int] = []
        self.a_O: list[int] = []

    def commit_var(self) -> Variable:
        raise RuntimeError("ProverCS takes committed values in the constructor")

    def public_var(self) -> Variable:
        raise RuntimeError("ProverCS takes public values in the constructor")

    def eval_lc(self, lc: LC) -> int:
        total = 0
        for var, c in lc.terms.items():
            if var.kind == VarKind.ONE:
                total += c
            elif var.kind == VarKind.COMMITTED:
                total += c * self.v[var.index]
            elif var.kind == VarKind.PUBLIC:
                total += c * self.pub[var.index]
            elif var.kind == VarKind.MUL_LEFT:
                total += c * self.a_L[var.index]
            elif var.kind == VarKind.MUL_RIGHT:
                total += c * self.a_R[var.index]
            else:
                total += c * self.a_O[var.index]
        return total % L

    def _assign_gate(self, i: int, left: LC, right: LC) -> None:
        l_val = self.eval_lc(left)
        r_val = self.eval_lc(right)
        self.a_L.append(l_val)
        self.a_R.append(r_val)
        self.a_O.append(l_val * r_val % L)

    def check_satisfied(self) -> bool:
        return all(self.eval_lc(lc) == 0 for lc in self.constraints)
