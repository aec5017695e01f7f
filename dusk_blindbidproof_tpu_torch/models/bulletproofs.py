"""Bulletproofs R1CS prover / verifier on tensors.

The same phase structure as the JAX package's engine:

  * circuit synthesis happens once per circuit shape (models.r1cs artifact);
  * the heavy math (vector commitments, constraint flattening,
    t-polynomial, inner-product folds) runs on the device over 13-bit-limb
    tensors (ops.limb / ops.msm), batched over independent proofs;
  * the Merlin transcript lives on the host; between device phases only
    canonical point limbs and challenge scalars cross, and the whole batch
    advances its transcripts in lockstep at each boundary;
  * the inner-product argument never folds generator vectors: coefficient
    vectors (c_G, c_H) accumulate the challenge products, so every L/R
    commitment is a fixed-base MSM against the window tables.

Transcript schedule (the bit-exactness contract):

  Transcript::new(label)                      # caller
  dom-sep "r1cs v1"                           # Prover / Verifier init
  append "V" per high-level commitment        # commit order = caller's
  append_u64 "m" = #commitments
  append "A_I1" "A_O1" "S1"
  dom-sep "r1cs-1phase"
  append "A_I2" "A_O2" "S2" (identity)
  challenge "y", "z"
  append "T_1" "T_3" "T_4" "T_5" "T_6"
  challenge "u", "x"
  append "t_x" "t_x_blinding" "e_blinding"
  challenge "w"
  dom-sep "ipp v1", append_u64 "n" = padded_n
  per round: append "L", "R"; challenge "u"
  verifier-only: challenge "r"

Every device function takes tensors on one device; the entry points
(`Prover`, `Verifier`) take `device=` and default to CUDA, or `mesh=`
(parallel.mesh: each rank proves its own rows, every rank returns the whole
batch).  Batches run at their natural size.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from ..ops import edwards, limb, msm, ristretto
from ..ops.limb import FL, FP, NLIMBS
from ..parallel import mesh as pmesh
from ..utils import curve_host as chost
from ..utils.curve_host import L, scalar_invert
from ..utils.merlin import Transcript
from ..utils.profiling import span
from .proof_struct import R1CSProof
from .r1cs import CircuitArtifact, VarKind
from .transcript_protocol import (
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

GENS_CAPACITY_DEFAULT = 2048


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for and there is no GPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain versions"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def _dev(arr, device) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.int32)).to(device)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def _compress_host(arr: np.ndarray) -> list[bytes]:
    """[..., 4, NLIMBS] CANONICAL point limbs (host numpy) -> flat list of
    32-byte Ristretto encodings.  The sqrt/inversion chain runs per point in
    host integers: at phase-output widths (a handful of points per proof)
    this beats the device chain's ~265 sequential tiny-width steps."""
    out = []
    for row in np.asarray(arr).reshape(-1, 4, NLIMBS):
        pt = chost.EdwardsPoint(*[limb.limbs_to_int(c) for c in row])
        out.append(chost.ristretto_compress(pt))
    return out


def _limb_row_to_int(row) -> int:
    return limb.limbs_to_int(row) % L


def _ones(shape, device) -> torch.Tensor:
    return limb.const(limb.int_to_limbs(1), device).expand(*shape, NLIMBS)


# ---------------------------------------------------------------------------
# Device phases
# ---------------------------------------------------------------------------


def vector_powers(x: torch.Tensor, count: int) -> torch.Tensor:
    """[B, NLIMBS] -> [B, count, NLIMBS] with powers x^1 .. x^count
    (log-doubling: ~log2(count) full-width limb muls)."""
    p = x[:, None, :]
    while p.shape[1] < count:
        last = p[:, -1:, :]
        p = torch.cat([p, limb.mul(FL, p, last)], dim=1)
    return p[:, :count, :]


def vector_powers_from_one(x: torch.Tensor, count: int) -> torch.Tensor:
    """x^0 .. x^(count-1)."""
    one = _ones((x.shape[0], 1), x.device)
    if count == 1:
        return one.clone()
    return torch.cat([one, vector_powers(x, count - 1)], dim=1)


@dataclass(eq=False)
class CompiledCircuit:
    """Device-resident constraint structure for one circuit shape."""

    n_pad: int
    n1: int
    m: int
    q: int
    n_pub: int
    # per var kind: (q_idx[E] int64, var_idx[E] int64, coeff_limbs[E, NL]) or None
    coo: dict
    # host copy of the COMMITTED entries [(q, j, coeff)] for the verifier
    committed: list

    @staticmethod
    def compile(artifact: CircuitArtifact, device="cpu") -> "CompiledCircuit":
        coo = {}
        for kind, (qs, idxs, coeffs) in artifact.entries.items():
            coo[int(kind)] = (
                None if len(qs) == 0
                else (qs, idxs, limb.ints_to_limbs_fast(coeffs))
            )
        return CompiledCircuit.from_artifact_arrays(
            artifact.n_gates, artifact.n_constraints, artifact.n_committed,
            artifact.n_public, coo, device,
        )

    @staticmethod
    def from_artifact_arrays(n_gates: int, n_constraints: int, n_committed: int,
                             n_public: int, coo: dict, device="cpu") -> "CompiledCircuit":
        """Numpy COO arrays {kind: (q_idx, var_idx, coeff_limbs) or None},
        keyed by `VarKind` value (the JAX package's `CompiledCircuit.coo`
        converted with np.asarray) -> this package's circuit on `device`."""
        dev = {}
        committed = []
        for kind in VarKind:
            entry = coo.get(int(kind))
            if entry is None:
                dev[kind] = None
                continue
            qs, idxs, coeffs = (np.asarray(a) for a in entry)
            dev[kind] = (
                torch.from_numpy(qs.astype(np.int64)).to(device),
                torch.from_numpy(idxs.astype(np.int64)).to(device),
                _dev(coeffs, device),
            )
            if kind == VarKind.COMMITTED:
                committed = list(zip(qs.tolist(), idxs.tolist(),
                                     limb.limbs_to_ints(coeffs)))
        n_pad = 1 << (max(n_gates, 1) - 1).bit_length()
        return CompiledCircuit(
            n_pad=n_pad, n1=n_gates, m=n_committed, q=n_constraints,
            n_pub=n_public, coo=dev, committed=committed,
        )


def _inner(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched inner product over dim -2: [B, n, NL] x [B, n, NL] -> [B, NL]."""
    return limb.add_many(FL, limb.mul(FL, a, b), dim=-2)


def flatten_constraints(circuit: CompiledCircuit, z: torch.Tensor,
                        publics: torch.Tensor):
    """z [B, NLIMBS], publics [B, n_pub, NL] ->
    (wL, wR, wO [B, n_pad, NL], wV [B, m, NL], wc [B, NL]) with the sign
    conventions of models.r1cs.CircuitArtifact; the PUBLIC symbols' constant
    contribution folds into wc: wc = wc_one + <wP, publics>."""
    B = z.shape[0]
    zq = vector_powers(z, circuit.q)  # z^1..z^Q

    def gather_sum(kind, size):
        out = torch.zeros((B, size, NLIMBS), dtype=torch.int32, device=z.device)
        entry = circuit.coo[kind]
        if entry is None:
            return out
        qs, idxs, coeffs = entry
        terms = limb.mul(FL, zq[:, qs, :], coeffs)  # [B, E, NL]
        out.index_add_(1, idxs, terms)  # duplicate indices accumulate
        return limb.normalize(FL, out)

    wL = gather_sum(VarKind.MUL_LEFT, circuit.n_pad)
    wR = gather_sum(VarKind.MUL_RIGHT, circuit.n_pad)
    wO = gather_sum(VarKind.MUL_OUT, circuit.n_pad)
    wV = limb.neg(FL, gather_sum(VarKind.COMMITTED, max(circuit.m, 1)))
    wc = limb.neg(FL, gather_sum(VarKind.ONE, 1))[:, 0, :]
    if circuit.n_pub:
        wP = limb.neg(FL, gather_sum(VarKind.PUBLIC, circuit.n_pub))
        wc = limb.add(FL, wc, _inner(wP, publics))
    return wL, wR, wO, wV, wc


def commit_vectors(tables, digits: torch.Tensor) -> torch.Tensor:
    """Batched fixed-base MSMs against the Pedersen window tables.

    digits: [..., 2cap+2, NLIMBS] scalars in table layout
    (G | H | B | B_blinding).  Returns canonical points [..., 4, NLIMBS]."""
    out = msm.msm_prescaled(tables.niels, limb.canon(FL, digits), niels=True)
    return limb.canon(FP, out)


def commit_pedersen_tiny(tables, values: torch.Tensor, blinds: torch.Tensor) -> torch.Tensor:
    """values, blinds: [..., NLIMBS] -> canonical points v*B + b*B~
    [..., 4, NLIMBS]: a fixed-base MSM against the pre-scaled B and
    B_blinding rows of the window tables."""
    cap = tables.cap
    tab = tables.table[2 * cap : 2 * cap + 2]  # [2, W, 4, NL]
    digits = torch.stack(
        [limb.canon(FL, values), limb.canon(FL, blinds)], dim=-2
    )  # [..., 2, NL]
    return limb.canon(FP, msm.msm_prescaled(tab, digits))


@dataclass
class GeneratorTables:
    """The fixed-base window tables of one generator capacity on a device:
    extended rows and their affine-Niels copy, layout G | H | B | B~."""

    cap: int
    table: torch.Tensor  # [2cap+2, WINDOWS, 4, NLIMBS]
    niels: torch.Tensor


def check_capacity(circuit: CompiledCircuit, cap: int) -> None:
    """Refuse a circuit larger than the generator capacity: an error of the
    request (ProofError), raised before any table or tensor work."""
    if circuit.n_pad > cap:
        raise ProofError(
            f"circuit exceeds generator capacity: n_pad {circuit.n_pad} > cap {cap}"
        )


def generator_tables(cap: int, device: torch.device) -> GeneratorTables:
    """The tables of `cap` generators on `device` (built once per process)."""
    table, _ = msm.pedersen_tables(cap, device)
    niels, _ = msm.pedersen_tables_niels(cap, device)
    return GeneratorTables(cap, table, niels)


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


@dataclass
class ProverWitness:
    """Per-batch witness arrays (host numpy limbs, canonical)."""

    a_L: np.ndarray  # [B, n_pad, NLIMBS]
    a_R: np.ndarray
    a_O: np.ndarray
    v: np.ndarray  # [B, m, NLIMBS]
    v_blinding: np.ndarray  # [B, m, NLIMBS]
    publics: np.ndarray  # [B, n_pub, NLIMBS]


def _sample_scalar_limbs(rng: np.random.Generator, shape) -> np.ndarray:
    """Uniform scalars in [0, 2^252) as canonical limbs (blinding factors)."""
    raw = np.frombuffer(
        rng.bytes(int(np.prod(shape)) * 32), dtype=np.uint8
    ).reshape(*shape, 32).copy()
    raw[..., 31] &= 0x0F  # keep 252 bits
    return limb.limbs_from_bytes_le(raw)


def _sample_int(rng: np.random.Generator) -> int:
    return int.from_bytes(rng.bytes(32), "little") & ((1 << 252) - 1)


def _cap_pad(B: int, n_pad: int, cap: int, device) -> list[torch.Tensor]:
    """The zero rows that take a [B, n_pad, NL] vector up to the generator
    capacity: one tensor, or none when n_pad == cap (the circuit's size was
    checked against cap before any work, see check_capacity)."""
    if cap > n_pad:
        return [torch.zeros((B, cap - n_pad, NLIMBS), dtype=torch.int32, device=device)]
    return []


def phase_a(tables, a_L, a_R, a_O, s_L, s_R, blinds):
    """Vector commitments A_I1, A_O1, S1 for a batch.

    a_*, s_*: [B, n_pad, NL] (s zero beyond n1); blinds: [B, 3, NL].
    Returns canonical points [B, 3, 4, NL].

    The three MSMs run one after another, each over [B, 2cap+2] digits: the
    bucket MSM keeps about three copies of its sorted items (336 bytes each),
    and one stacked [B, 3, 2cap+2] MSM at cap = 2^16 and B = 16 would need
    some 127 GB.  An MSM's rows are independent, so the points are the ones
    the stacked MSM gives."""
    cap = tables.cap
    B, n_pad, _ = a_L.shape
    zero = torch.zeros_like(a_L)
    zpad = _cap_pad(B, n_pad, cap, a_L.device)
    zero1 = torch.zeros((B, 1, NLIMBS), dtype=torch.int32, device=a_L.device)

    def commit(g, h, blind):  # [B, 2cap+2, NL] digits -> [B, 4, NL]
        return commit_vectors(
            tables, torch.cat([g, *zpad, h, *zpad, zero1, blind[:, None, :]], dim=1))

    return torch.stack(
        [
            commit(a_L, a_R, blinds[:, 0]),
            commit(a_O, zero, blinds[:, 1]),
            commit(s_L, s_R, blinds[:, 2]),
        ],
        dim=1,
    )


def phase_t(a_L, a_R, a_O, s_L, s_R, wL, wR, wO, y_pows, y_inv_pows):
    """l/r polynomial coefficient vectors and t1..t6.

    y_pows / y_inv_pows: [B, n_pad, NL] = y^0..y^(n-1) and inverses.
    Returns (l1, l2, l3, r0, r1, r3, t [B, 6, NL])."""
    l1 = limb.add(FL, a_L, limb.mul(FL, y_inv_pows, wR))
    l2 = a_O
    l3 = s_L
    r0 = limb.sub(FL, wO, y_pows)
    r1 = limb.add(FL, limb.mul(FL, y_pows, a_R), wL)
    r3 = limb.mul(FL, y_pows, s_R)
    t1 = _inner(l1, r0)
    t2 = limb.add(FL, _inner(l1, r1), _inner(l2, r0))
    t3 = limb.add(FL, _inner(l3, r0), _inner(l2, r1))
    t4 = limb.add(FL, _inner(l3, r1), _inner(l1, r3))
    t5 = _inner(l2, r3)
    t6 = _inner(l3, r3)
    t = torch.stack([t1, t2, t3, t4, t5, t6], dim=1)
    return l1, l2, l3, r0, r1, r3, t


def phase_lr(l1, l2, l3, r0, r1, r3, x):
    """Evaluate l(x), r(x): x [B, NL] -> l, r [B, n_pad, NL]."""
    xe = x[:, None, :]
    x2 = limb.sqr(FL, xe)
    x3 = limb.mul(FL, x2, xe)
    l = limb.add(
        FL,
        limb.mul(FL, l1, xe),
        limb.add(FL, limb.mul(FL, l2, x2), limb.mul(FL, l3, x3)),
    )
    r = limb.add(
        FL,
        r0,
        limb.add(FL, limb.mul(FL, r1, xe), limb.mul(FL, r3, x3)),
    )
    return l, r


def _ipa_lr(tables, a, b, c_G, c_H, w_limb, h: int):
    """One IPA round's L/R commitments at half length h.

    Select-table MSM: original generator k contributes to L through EITHER
    G_k (hi position: digit a_lo*c_G) or H_k (lo position: digit b_hi*c_H),
    never both, so L/R are MSMs over cap+1 table rows (points selected
    per k from the G/H window tables) instead of 2cap+2 rows half-filled
    with zero digits.  Returns (canonical points [B, 2, 4, NL], c_L, c_R)."""
    cap = tables.cap
    dev = a.device
    tab = tables.niels
    tab_G, tab_H = tab[:cap], tab[cap : 2 * cap]
    tab_B = tab[2 * cap : 2 * cap + 1]

    idx = torch.arange(cap, device=dev)
    pos = idx % (2 * h)  # original k -> current position
    in_lo = pos < h

    def at(v, i):
        return v[:, i.clamp(0, cap - 1)]

    # current-vector element feeding original gen k:
    #   L, G side (hi positions p >= h): a_lo[p-h] = a[p-h]
    #   L, H side (lo positions p < h):  b_hi[p]   = b[p+h]
    #   R, G side (lo positions p < h):  a_hi[p]   = a[p+h]
    #   R, H side (hi positions p >= h): b_lo[p-h] = b[p-h]
    sel = in_lo[None, :, None]
    dig_L = torch.where(
        sel, limb.mul(FL, at(b, pos + h), c_H), limb.mul(FL, at(a, pos - h), c_G)
    )
    dig_R = torch.where(
        sel, limb.mul(FL, at(a, pos + h), c_G), limb.mul(FL, at(b, pos - h), c_H)
    )
    sel_pt = in_lo[:, None, None, None]
    pts_L = torch.where(sel_pt, tab_H, tab_G)  # [cap, W, 4, NL]
    pts_R = torch.where(sel_pt, tab_G, tab_H)

    # inner products over the active halves
    mask_lo = (idx < h)[None, :, None]
    c_L = limb.add_many(
        FL, torch.where(mask_lo, limb.mul(FL, a, at(b, idx + h)), 0), dim=-2
    )
    c_R = limb.add_many(
        FL, torch.where(mask_lo, limb.mul(FL, at(a, idx + h), b), 0), dim=-2
    )
    wB_L = limb.mul(FL, w_limb, c_L)[:, None, :]
    wB_R = limb.mul(FL, w_limb, c_R)[:, None, :]

    digits = limb.canon(
        FL,
        torch.stack(
            [torch.cat([dig_L, wB_L], dim=1), torch.cat([dig_R, wB_R], dim=1)],
            dim=1,
        ),
    )  # [B, 2, cap+1, NL]
    pts = torch.stack(
        [torch.cat([pts_L, tab_B], dim=0), torch.cat([pts_R, tab_B], dim=0)]
    )  # [2, cap+1, W, 4, NL]
    out = msm.msm_prescaled(pts, digits, niels=True)
    return limb.canon(FP, out), c_L, c_R


def _ipa_fold_state(a, b, c_G, c_H, u, u_inv, h: int):
    """Fold after challenge u: new a/b of length h (stored in prefix),
    update the c_G/c_H coefficient vectors."""
    cap = a.shape[1]
    idx = torch.arange(cap, device=a.device)
    in_lo = (idx % (2 * h)) < h
    hi = (idx + h).clamp(0, cap - 1)
    ue = u[:, None, :]
    uie = u_inv[:, None, :]
    new_a = limb.add(FL, limb.mul(FL, a, ue), limb.mul(FL, a[:, hi], uie))
    new_b = limb.add(FL, limb.mul(FL, b, uie), limb.mul(FL, b[:, hi], ue))
    keep = (idx < h)[None, :, None]
    a2 = torch.where(keep, new_a, 0)
    b2 = torch.where(keep, new_b, 0)
    cg_mult = torch.where(in_lo[None, :, None], uie, ue)
    ch_mult = torch.where(in_lo[None, :, None], ue, uie)
    return a2, b2, limb.mul(FL, c_G, cg_mult), limb.mul(FL, c_H, ch_mult)


def _batch_invert(vals: list[int]) -> list[int]:
    """Montgomery batch inversion mod L (one pow for the whole batch)."""
    if not vals:
        return []
    prefix = [1]
    for v in vals:
        prefix.append(prefix[-1] * v % L)
    inv_all = pow(prefix[-1], L - 2, L)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv_all % L
        inv_all = inv_all * vals[i] % L
    return out


class _MeshRows:
    """The rows of a batch that this process proves or verifies.

    Without a mesh: every row, on `device` (default CUDA).  With a
    `parallel.mesh.Mesh`: every rank is given the same full batch and works on
    the contiguous rows of its bids index, on the mesh's device; the results
    are gathered over the bids axis, so every rank returns the full batch's in
    batch order, byte-identical to mesh=None.  A rank advances the transcripts
    of its own rows only; a rank with no rows still joins every gather."""

    def __init__(self, transcripts: list[Transcript], device, mesh):
        if mesh is not None and device is not None:
            raise ValueError("with a mesh the device is the mesh's")
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
            self.rows = slice(None)
            self.transcripts = transcripts
        else:
            self.device = mesh.device
            self.rows = pmesh.bid_rows(mesh, len(transcripts))
            self.transcripts = transcripts[self.rows]

    def _gather(self, local: list) -> list:
        return local if self.mesh is None else pmesh.gather_rows(self.mesh, local)


class Prover(_MeshRows):
    """Batched R1CS prover: construct with transcripts (one per proof in
    the batch), commit values, then prove() against a compiled circuit."""

    def __init__(self, transcripts: list[Transcript], cap: int = GENS_CAPACITY_DEFAULT,
                 device=None, mesh=None):
        super().__init__(transcripts, device, mesh)
        self.cap = cap
        self.tables = generator_tables(cap, self.device)
        for t in self.transcripts:
            r1cs_domain_sep(t)

    def _ints(self, vals, shape=None) -> torch.Tensor:
        return _dev(limb.ints_to_limbs_fast(vals, shape), self.device)

    def commit_batch(self, values, blindings) -> list[list[bytes]]:
        """values, blindings: [B][m] python ints -> per-proof compressed
        commitment lists of the whole batch; appends this process's rows to
        their transcripts."""
        values, blindings = values[self.rows], blindings[self.rows]
        if not values:
            return self._gather([])
        B, m = len(values), len(values[0])
        with span("prove.commit_V"):
            comp = _host(commit_pedersen_tiny(
                self.tables,
                self._ints([values[i][j] % L for i in range(B) for j in range(m)], (B, m)),
                self._ints([blindings[i][j] % L for i in range(B) for j in range(m)], (B, m)),
            ))
        out = []
        with span("prove.commit_V_host"):  # compression and transcript, B x m points
            for i, t in enumerate(self.transcripts):
                row = _compress_host(comp[i])
                for c in row:
                    append_point(t, b"V", c)
                out.append(row)
        return self._gather(out)

    def prove(self, circuit: CompiledCircuit, witness: ProverWitness,
              seed: bytes = b"\x00" * 32) -> list[R1CSProof]:
        """The proofs of the whole batch; `witness` holds the whole batch's
        rows, of which a rank of a mesh reads its own alone.  A circuit larger
        than the capacity raises ProofError before any work (on every rank of
        a mesh alike, with no collective)."""
        check_capacity(circuit, self.cap)
        if self.mesh is None:
            return self._prove_rows(circuit, witness, seed)
        local = []
        if self.transcripts:
            rows = ProverWitness(*(getattr(witness, f.name)[self.rows]
                                   for f in fields(ProverWitness)))
            local = self._prove_rows(circuit, rows, seed)
        return [R1CSProof.from_bytes(b) for b in self._gather([p.to_bytes() for p in local])]

    def _prove_rows(self, circuit: CompiledCircuit, witness: ProverWitness,
                    seed: bytes) -> list[R1CSProof]:
        cap, n_pad, n1 = self.cap, circuit.n_pad, circuit.n1
        ts = self.transcripts
        B = len(ts)
        dev = self.device

        for t in ts:
            t.append_u64(b"m", circuit.m)

        # deterministic blinding RNG: transcript-bound (the Merlin
        # TranscriptRng seeds a numpy generator per proof)
        with span("prove.host_rng"):
            rngs = []
            for i, t in enumerate(ts):
                builder = t.build_rng()
                for j in range(circuit.m):
                    builder = builder.rekey_with_witness_bytes(
                        b"v_blinding",
                        bytes(limb.limbs_to_bytes_le(witness.v_blinding[i, j])),
                    )
                rngs.append(np.random.default_rng(
                    list(builder.finalize(seed).fill_bytes(32))
                ))
            i_blind = np.stack([_sample_scalar_limbs(r, (3,)) for r in rngs])
            s_L = np.stack([_sample_scalar_limbs(r, (n_pad,)) for r in rngs])
            s_R = np.stack([_sample_scalar_limbs(r, (n_pad,)) for r in rngs])
            s_L[:, n1:] = 0
            s_R[:, n1:] = 0

        a_L, a_R, a_O = (_dev(x, dev) for x in (witness.a_L, witness.a_R, witness.a_O))
        s_L, s_R = _dev(s_L, dev), _dev(s_R, dev)

        with span("prove.phase_a"):
            comp_a = _host(phase_a(self.tables, a_L, a_R, a_O, s_L, s_R,
                                   _dev(i_blind, dev)))
        ys, zs, A_bytes = [], [], []
        with span("prove.host_yz"):
            for i, t in enumerate(ts):
                ai, ao, s = _compress_host(comp_a[i])
                append_point(t, b"A_I1", ai)
                append_point(t, b"A_O1", ao)
                append_point(t, b"S1", s)
                r1cs_1phase_domain_sep(t)
                append_point(t, b"A_I2", IDENTITY_COMPRESSED)
                append_point(t, b"A_O2", IDENTITY_COMPRESSED)
                append_point(t, b"S2", IDENTITY_COMPRESSED)
                ys.append(challenge_scalar(t, b"y"))
                zs.append(challenge_scalar(t, b"z"))
                A_bytes.append((ai, ao, s))

        with span("prove.phase_t"):
            wL, wR, wO, wV, wc = flatten_constraints(
                circuit, self._ints(zs), _dev(witness.publics, dev)
            )
            y_pows = vector_powers_from_one(self._ints(ys), n_pad)
            y_inv_pows = vector_powers_from_one(self._ints(_batch_invert(ys)), n_pad)
            l1, l2, l3, r0, r1_, r3, t_coeffs = phase_t(
                a_L, a_R, a_O, s_L, s_R, wL, wR, wO, y_pows, y_inv_pows
            )
            t_host = _host(limb.canon(FL, t_coeffs))  # [B, 6, NL]
            wV_host = _host(limb.canon(FL, wV))

        with span("prove.host_T"):
            # T commitments: t2's blinding is <wV, gamma>
            t_blind, t_vals, t_blinds = {}, [], []
            for i in range(B):
                tb = {k: _sample_int(rngs[i]) for k in (1, 3, 4, 5, 6)}
                gamma = [_limb_row_to_int(witness.v_blinding[i, j]) for j in range(circuit.m)]
                wv = [_limb_row_to_int(wV_host[i, j]) for j in range(circuit.m)]
                tb[2] = sum(w * g for w, g in zip(wv, gamma)) % L
                t_blind[i] = tb
                for k in (1, 3, 4, 5, 6):
                    t_vals.append(_limb_row_to_int(t_host[i, k - 1]))
                    t_blinds.append(tb[k])
        with span("prove.commit_T"):
            T_comp = _host(commit_pedersen_tiny(
                self.tables, self._ints(t_vals, (B, 5)), self._ints(t_blinds, (B, 5))
            ))

        us, xs, ws_, txs, txbs, ebs, T_bytes_all = [], [], [], [], [], [], []
        with span("prove.host_uxw"):
            for i, t in enumerate(ts):
                T_bytes = _compress_host(T_comp[i])
                for label, tb in zip([b"T_1", b"T_3", b"T_4", b"T_5", b"T_6"], T_bytes):
                    append_point(t, label, tb)
                T_bytes_all.append(T_bytes)
                u = challenge_scalar(t, b"u")
                x = challenge_scalar(t, b"x")
                us.append(u)
                xs.append(x)
                t_int = [_limb_row_to_int(t_host[i, k]) for k in range(6)]
                t_b = t_blind[i]
                t_x = sum(t_int[k - 1] * pow(x, k, L) for k in range(1, 7)) % L
                t_x_blinding = sum(t_b[k] * pow(x, k, L) for k in range(1, 7)) % L
                ib = [_limb_row_to_int(i_blind[i, j]) for j in range(3)]
                e_blinding = (ib[0] * x + ib[1] * x * x + ib[2] * pow(x, 3, L)) % L
                append_scalar(t, b"t_x", t_x)
                append_scalar(t, b"t_x_blinding", t_x_blinding)
                append_scalar(t, b"e_blinding", e_blinding)
                ws_.append(challenge_scalar(t, b"w"))
                txs.append(t_x)
                txbs.append(t_x_blinding)
                ebs.append(e_blinding)

        with span("prove.phase_lr"):
            l_vec, r_vec = phase_lr(l1, l2, l3, r0, r1_, r3, self._ints(xs))

        # ---- inner-product argument -------------------------------------
        for t in ts:
            innerproduct_domain_sep(t, n_pad)

        # G_factors: 1 for i < n1, u for i >= n1; c_H = y^{-i} * G_factor
        u_col = self._ints(us)[:, None, :].expand(B, n_pad, NLIMBS)
        pad_mask = torch.arange(n_pad, device=dev)[None, :, None] >= n1
        c_G = torch.where(pad_mask, u_col, _ones((B, n_pad), dev))
        c_H = limb.mul(FL, y_inv_pows, c_G)

        # pad up to cap (generators beyond n_pad are never used: coeff 0)
        zpad = _cap_pad(B, n_pad, cap, dev)
        c_G, c_H, a_vec, b_vec = (
            torch.cat([v, *zpad], dim=1) for v in (c_G, c_H, l_vec, r_vec)
        )
        w_l = self._ints(ws_)
        L_rounds: list[list[bytes]] = [[] for _ in range(B)]
        R_rounds: list[list[bytes]] = [[] for _ in range(B)]
        h = n_pad // 2
        while h >= 1:
            with span("prove.ipa_round"):
                lr_host = _host(_ipa_lr(self.tables, a_vec, b_vec, c_G, c_H, w_l, h)[0])
            with span("prove.ipa_host"):
                u_ints = []
                for i, t in enumerate(ts):
                    lb, rb = _compress_host(lr_host[i])
                    append_point(t, b"L", lb)
                    append_point(t, b"R", rb)
                    L_rounds[i].append(lb)
                    R_rounds[i].append(rb)
                    u_ints.append(challenge_scalar(t, b"u"))
            with span("prove.ipa_fold"):
                a_vec, b_vec, c_G, c_H = _ipa_fold_state(
                    a_vec, b_vec, c_G, c_H, self._ints(u_ints),
                    self._ints(_batch_invert(u_ints)), h,
                )
            h //= 2

        with span("prove.ipa_final"):
            ab_host = _host(limb.canon(FL, torch.stack([a_vec[:, 0], b_vec[:, 0]], dim=1)))

        proofs = []
        for i in range(B):
            ai, ao, s = A_bytes[i]
            T = T_bytes_all[i]
            proofs.append(R1CSProof(
                A_I1=ai, A_O1=ao, S1=s,
                A_I2=IDENTITY_COMPRESSED, A_O2=IDENTITY_COMPRESSED,
                S2=IDENTITY_COMPRESSED,
                T_1=T[0], T_3=T[1], T_4=T[2], T_5=T[3], T_6=T[4],
                t_x=txs[i], t_x_blinding=txbs[i], e_blinding=ebs[i],
                ipp_L=L_rounds[i], ipp_R=R_rounds[i],
                ipp_a=_limb_row_to_int(ab_host[i, 0]),
                ipp_b=_limb_row_to_int(ab_host[i, 1]),
            ))
        return proofs


# ---------------------------------------------------------------------------
# Verifier
#
# Verification equation: with challenges y, z, u, x, w, IPA rounds u_j,
# batching challenge r, s_i = prod_j u_j^{+-1}, f_i = G_factors:
#
#   0 =  sum_i [a s_i f_i - x y^{-i} wR_i] G_i
#      + sum_i [b s^{-1}_i y^{-i} f_i - y^{-i}(x wL_i + wO_i) + f_i] H_i
#      + (w (ab - t_x) + r (t_x - x^2 (delta + wc))) B
#      + (e_blinding + r t_x_blinding) B~
#      - sum_j r x^2 wV_j V_j
#      - sum_k r x^k T_k   (k in 1,3,4,5,6)
#      - x A_I1 - x^2 A_O1 - x^3 S1  (- u x A_I2 - u x^2 A_O2 - u x^3 S2)
#      - sum_j u_j^2 L_j - sum_j u_j^{-2} R_j
#
# with delta = <y^{-n} o wR, wL>.
# ---------------------------------------------------------------------------


def verify_scalars(circuit: CompiledCircuit, cap: int, z, y_inv, x, w, r,
                   a, b, u_vec, u_inv_vec, u_phase, t_x, t_x_blinding,
                   e_blinding, publics):
    """Batched verification scalar assembly -> canonical fixed-base digits
    [B, 2cap+2, NLIMBS].  u_vec/u_inv_vec: [B, rounds, NL]."""
    B = z.shape[0]
    dev = z.device
    n_pad = circuit.n_pad
    rounds = u_vec.shape[1]
    wL, wR, wO, wV, wc = flatten_constraints(circuit, z, publics)
    y_inv_pows = vector_powers_from_one(y_inv, n_pad)

    # s vector from the IPA challenges: bit j of index i (MSB-first rounds)
    s = _ones((B, n_pad), dev)
    idx = torch.arange(n_pad, device=dev)
    for j in range(rounds):
        bit = (((idx >> (rounds - 1 - j)) & 1) == 1)[None, :, None]
        s = limb.mul(FL, s, torch.where(bit, u_vec[:, j, None, :], u_inv_vec[:, j, None, :]))
    s_inv = s.flip(1)

    pad_mask = (idx >= circuit.n1)[None, :, None]
    f = torch.where(pad_mask, u_phase[:, None, :].expand(B, n_pad, NLIMBS),
                    _ones((B, n_pad), dev))

    xe, a_e, b_e = x[:, None, :], a[:, None, :], b[:, None, :]
    g_scalars = limb.sub(
        FL,
        limb.mul(FL, limb.mul(FL, a_e, s), f),
        limb.mul(FL, limb.mul(FL, xe, y_inv_pows), wR),
    )
    h_scalars = limb.add(
        FL,
        limb.sub(
            FL,
            limb.mul(FL, limb.mul(FL, b_e, s_inv), limb.mul(FL, y_inv_pows, f)),
            limb.mul(FL, y_inv_pows, limb.add(FL, limb.mul(FL, xe, wL), wO)),
        ),
        f,
    )

    delta = _inner(limb.mul(FL, y_inv_pows, wR), wL)
    x2 = limb.sqr(FL, x)
    # Q = w*B, so the IPA's ab*Q term carries the w factor: w*(ab - t_x)
    wab_t = limb.mul(FL, w, limb.sub(FL, limb.mul(FL, a, b), t_x))
    b_scalar = limb.add(
        FL,
        wab_t,
        limb.mul(FL, r, limb.sub(FL, t_x, limb.mul(FL, x2, limb.add(FL, delta, wc)))),
    )
    bblind_scalar = limb.add(FL, e_blinding, limb.mul(FL, r, t_x_blinding))

    zpad = _cap_pad(B, n_pad, cap, dev)
    digits = torch.cat(
        [g_scalars, *zpad, h_scalars, *zpad, b_scalar[:, None, :], bblind_scalar[:, None, :]],
        dim=1,
    )
    return limb.canon(FL, digits)


def verify_msm_fixed(tables, digits: torch.Tensor) -> torch.Tensor:
    """Fixed-base verification MSM over the generator window tables."""
    return msm.msm_prescaled(tables.niels, digits, niels=True)


def verify_check(fixed: torch.Tensor, dynamic: torch.Tensor) -> torch.Tensor:
    """Combine the two MSM halves and test the Ristretto identity.

    The MSM sums Ristretto *representatives*, so the total can land on any
    4-torsion coset representative of the identity, e.g. (0, -1), depending
    on which Edwards points the proof bytes decompressed to: the total is
    the Ristretto identity iff X == 0 or Y == 0 (mod p)."""
    total = edwards.add(fixed, dynamic)
    return limb.is_zero(FP, total[..., 0, :]) | limb.is_zero(FP, total[..., 1, :])


def _lex_ge(a: np.ndarray, bound: np.ndarray) -> np.ndarray:
    """Lexicographic a >= bound along the last axis (big-endian byte rows)."""
    diff = a != bound
    first = np.argmax(diff, axis=-1)
    any_diff = np.any(diff, axis=-1)
    picked = np.take_along_axis(a, first[..., None], axis=-1)[..., 0]
    return np.where(any_diff, picked > bound[first], True)


class Verifier(_MeshRows):
    """Batched R1CS verifier: replays the transcript schedule and evaluates
    the statement as one fixed-base MSM plus one small dynamic MSM."""

    def __init__(self, transcripts: list[Transcript], cap: int = GENS_CAPACITY_DEFAULT,
                 device=None, mesh=None):
        super().__init__(transcripts, device, mesh)
        self.cap = cap
        self.tables = generator_tables(cap, self.device)
        for t in self.transcripts:
            r1cs_domain_sep(t)

    def commit_batch(self, commitments: list[list[bytes]]) -> None:
        """The whole batch's commitments; this process's rows are appended."""
        with span("verify.commit_V"):
            for t, row in zip(self.transcripts, commitments[self.rows]):
                for c in row:
                    append_point(t, b"V", c)

    def _ints(self, vals, shape=None) -> torch.Tensor:
        return _dev(limb.ints_to_limbs_fast(vals, shape), self.device)

    def verify(self, circuit: CompiledCircuit, proofs: list[R1CSProof],
               commitments: list[list[bytes]], publics: np.ndarray) -> list[bool]:
        """The verdicts of the whole batch.  publics: [B, n_pub, NLIMBS]
        canonical public-input limbs.  A malformed proof raises ProofError
        for the whole batch, on every rank of a mesh; so does a circuit
        larger than the capacity, before any work."""
        check_capacity(circuit, self.cap)
        if self.mesh is None:
            return self._verify_rows(circuit, proofs, commitments, publics)
        local = []
        if self.transcripts:
            try:
                local = self._verify_rows(circuit, proofs[self.rows], commitments[self.rows],
                                          publics[self.rows])
            except ProofError as exc:
                # the batch's answer, as without a mesh: every rank raises it below
                local = [str(exc)]
        out = self._gather(local)
        for v in out:
            if isinstance(v, str):
                raise ProofError(v)
        return out

    def _verify_rows(self, circuit: CompiledCircuit, proofs: list[R1CSProof],
                     commitments: list[list[bytes]], publics: np.ndarray) -> list[bool]:
        ts = self.transcripts
        B = len(ts)
        n_pad = circuit.n_pad
        rounds = n_pad.bit_length() - 1

        per = []
        with span("verify.transcript"):
            for t, proof in zip(ts, proofs):
                if len(proof.ipp_L) != rounds:
                    raise ProofError("wrong number of IPA rounds")
                t.append_u64(b"m", circuit.m)
                validate_and_append_point(t, b"A_I1", proof.A_I1)
                validate_and_append_point(t, b"A_O1", proof.A_O1)
                validate_and_append_point(t, b"S1", proof.S1)
                r1cs_1phase_domain_sep(t)
                append_point(t, b"A_I2", proof.A_I2)
                append_point(t, b"A_O2", proof.A_O2)
                append_point(t, b"S2", proof.S2)
                y = challenge_scalar(t, b"y")
                z = challenge_scalar(t, b"z")
                for label, tb in zip(
                    [b"T_1", b"T_3", b"T_4", b"T_5", b"T_6"],
                    [proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6],
                ):
                    append_point(t, label, tb)
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
                per.append(dict(y=y, z=z, u=u, x=x, w=w, u_js=u_js, r=r))

        u_js_flat = [uj for p in per for uj in p["u_js"]]
        u_inv_flat = _batch_invert(u_js_flat)

        def host_wV(z: int) -> list[int]:
            wv = [0] * circuit.m
            for q, j, c in circuit.committed:
                wv[j] = (wv[j] - pow(z, q + 1, L) * c) % L
            return wv

        # dynamic points: V_j | T_k | A_I1 A_O1 S1 [A_I2 A_O2 S2] | L_j | R_j
        dyn_pts_bytes, dyn_scalars = [], []
        with span("verify.assemble"):
            for i, (p, proof) in enumerate(zip(per, proofs)):
                x, r, u = p["x"], p["r"], p["u"]
                x2 = x * x % L
                wv = host_wV(p["z"])
                row_pts = list(commitments[i])
                row_scalars = [(-r * x2 * wv[j]) % L for j in range(len(commitments[i]))]
                for k, tb in zip((1, 3, 4, 5, 6),
                                 (proof.T_1, proof.T_3, proof.T_4, proof.T_5, proof.T_6)):
                    row_pts.append(tb)
                    row_scalars.append((-r * pow(x, k, L)) % L)
                row_pts += [proof.A_I1, proof.A_O1, proof.S1]
                row_scalars += [(-x) % L, (-x2) % L, (-x2 * x) % L]
                if not proof.missing_phase2():
                    row_pts += [proof.A_I2, proof.A_O2, proof.S2]
                    row_scalars += [(-u * x) % L, (-u * x2) % L, (-u * x2 * x) % L]
                for uj, ujinv, lb, rb in zip(
                    p["u_js"], u_inv_flat[i * rounds : (i + 1) * rounds],
                    proof.ipp_L, proof.ipp_R,
                ):
                    row_pts += [lb, rb]
                    row_scalars += [(-uj * uj) % L, (-ujinv * ujinv) % L]
                dyn_pts_bytes.append(row_pts)
                dyn_scalars.append(row_scalars)

        K = len(dyn_pts_bytes[0])
        if any(len(rp) != K for rp in dyn_pts_bytes):
            raise ProofError("inconsistent proof shapes in batch")

        all_bytes = np.frombuffer(
            b"".join(b"".join(row) for row in dyn_pts_bytes), dtype=np.uint8
        ).reshape(B, K, 32)
        with span("verify.point_checks"):
            # canonical encodings only: s even and s < p (raw-byte checks)
            odd = (all_bytes[..., 0] & 1) != 0
            p_bytes = np.frombuffer((2**255 - 19).to_bytes(32, "little"), dtype=np.uint8)
            ge_p = _lex_ge(all_bytes[..., ::-1], p_bytes[::-1])
            is_zero_enc = ~np.any(all_bytes, axis=-1)
            if np.any((odd | ge_p) & ~is_zero_enc):
                raise ProofError("non-canonical point encoding")
        with span("verify.decompress"):
            dyn_points, valid = ristretto.decompress(
                _dev(limb.limbs_from_bytes_le(all_bytes), self.device)
            )
            # the identity (all-zero) encoding decompresses validly; any
            # other invalid encoding must be rejected
            if np.any(~_host(valid) & ~is_zero_enc):
                raise ProofError("invalid point encoding in proof")

        with span("verify.device"):
            fixed_digits = verify_scalars(
                circuit, self.cap,
                self._ints([p["z"] for p in per]),
                self._ints([scalar_invert(p["y"]) for p in per]),
                self._ints([p["x"] for p in per]),
                self._ints([p["w"] for p in per]),
                self._ints([p["r"] for p in per]),
                self._ints([pr.ipp_a for pr in proofs]),
                self._ints([pr.ipp_b for pr in proofs]),
                self._ints(u_js_flat, (B, rounds)),
                self._ints(u_inv_flat, (B, rounds)),
                self._ints([p["u"] for p in per]),
                self._ints([pr.t_x for pr in proofs]),
                self._ints([pr.t_x_blinding for pr in proofs]),
                self._ints([pr.e_blinding for pr in proofs]),
                _dev(publics, self.device),
            )
            fixed_pt = verify_msm_fixed(self.tables, fixed_digits)
            dyn_pt = msm.msm(
                dyn_points,
                self._ints([s for row in dyn_scalars for s in row], (B, K)),
            )
            ok = verify_check(fixed_pt, dyn_pt)
        return [bool(v) for v in _host(ok)]
