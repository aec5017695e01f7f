"""BlindBid prove/verify — the application layer on tensors.

  * `prove_batch` commits [d, k, y, y_inv] then the one-hot toggle bits (the
    `y` commitment is transcripted but never wired into the circuit, exactly
    as in the reference), synthesizes the shared gadget shape, and runs the
    device-phase prover.
  * `verify_batch` recommits, uses the same gadget shape, and runs one
    fixed-base plus one dynamic MSM.

Both take `device=` (default CUDA; see models.bulletproofs.resolve_device)
or `mesh=` (parallel.mesh: every rank passes the same full batch, proves or
verifies the rows of its bids index and returns the whole batch's results,
byte-identical to mesh=None).  The circuit shape is cached per list length
and device, and is made first.  Before it, the list is held to the generator
capacity from its length alone (`check_list_len`): an empty list is refused
with ValueError and one too long with ProofError, before any synthesis, table
or kernel launch.  The witness is generated by a host routine mirroring the
gadget's gate order, and crosses to the device as 8 words a value.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np

from ..ops import limb
from ..parallel import mesh as pmesh
from ..utils.curve_host import L, scalar_invert
from ..utils.merlin import Transcript
from ..utils.profiling import span
from .bulletproofs import (
    CompiledCircuit,
    Prover,
    ProverWitness,
    Verifier,
    check_capacity,
    resolve_device,
)
from .constants import GENS_CAPACITY, TRANSCRIPT_LABEL, mimc_constants
from .gadgets import blindbid_n_pad, mimc_hash, proof_gadget
from .proof_struct import BlindBidProof, R1CSProof
from .r1cs import LC, VerifierCS


@dataclass
class ProveRequest:
    """Opcode-1 payload: scalars are canonical ints; the pub_list keeps raw
    (possibly non-canonical, from_bits) values."""

    d: int
    k: int
    y: int
    y_inv: int
    q: int
    z_img: int
    seed: int
    pub_list: list[int]
    toggle: int


@dataclass
class VerifyRequest:
    """Opcode-2 payload."""

    proof: BlindBidProof
    score: int
    z_img: int
    seed: int
    pub_list: list[int]


@functools.lru_cache(maxsize=8)
def blindbid_circuit(list_len: int, device="cpu") -> CompiledCircuit:
    """Synthesize the circuit shape once per list length.

    Public symbol order: [q, z_img, seed, items...]; committed order:
    [d, k, y, y_inv, toggles...]."""
    cs = VerifierCS()
    v = [cs.commit_var() for _ in range(4)]
    toggles = [cs.commit_var() for _ in range(list_len)]
    q = cs.public_var()
    z_img = cs.public_var()
    seed = cs.public_var()
    items = [cs.public_var() for _ in range(list_len)]
    proof_gadget(
        cs, v[0], v[1], v[3], q, z_img, seed, mimc_constants(), toggles,
        [LC.of(i) for i in items],
    )
    return CompiledCircuit.compile(cs.artifact(), device)


def _mimc_witness(a_L, a_R, a_O, left: int, key: int, constants) -> int:
    """Append one mimc_gadget call's gate values; returns the output value."""
    x = left % L
    key = key % L
    for c in constants:
        a = (x + key + c) % L
        a2 = a * a % L
        a3 = a2 * a % L
        a4 = a2 * a2 % L
        a7 = a4 * a3 % L
        a_L += [a, a2, a2, a4]
        a_R += [a, a, a2, a3]
        a_O += [a2, a3, a4, a7]
        x = a7
    return (x + key) % L


def blindbid_witness(req: ProveRequest):
    """Gate assignments in the gadget's exact gate order
    (models.gadgets.proof_gadget)."""
    consts = mimc_constants()
    a_L: list[int] = []
    a_R: list[int] = []
    a_O: list[int] = []
    m = _mimc_witness(a_L, a_R, a_O, req.k, 0, consts)
    x = _mimc_witness(a_L, a_R, a_O, req.d, m, consts)
    # one_of_many: booleanity gates per toggle
    toggles = [1 if i == req.toggle else 0 for i in range(len(req.pub_list))]
    for t in toggles:
        a_L.append(t)
        a_R.append((1 - t) % L)
        a_O.append(t * (1 - t) % L)
    # membership gates: items[i]*toggle[i], toggle[i]*x
    for item, t in zip(req.pub_list, toggles):
        a_L.append(item % L)
        a_R.append(t)
        a_O.append(item * t % L)
        a_L.append(t)
        a_R.append(x)
        a_O.append(t * x % L)
    y = _mimc_witness(a_L, a_R, a_O, req.seed, x, consts)
    _mimc_witness(a_L, a_R, a_O, req.seed, m, consts)
    # score gadget: y * y_inv, d * y_inv
    a_L.append(y)
    a_R.append(req.y_inv % L)
    a_O.append(y * req.y_inv % L)
    a_L.append(req.d % L)
    a_R.append(req.y_inv % L)
    a_O.append(req.d * req.y_inv % L)
    return a_L, a_R, a_O


def witness_words(wires, rows, B: int, n_pad: int) -> np.ndarray:
    """The wires of `blindbid_witness` for the batch rows `rows` as
    [3, B, n_pad, 8] little-endian int32 words (a_L, a_R, a_O): the 32 bytes
    of each canonical value, zero past the gates and in the rows not given (a
    mesh rank's view).  The prover turns them into limbs on its device."""
    buf = np.zeros((3, B, n_pad, 32), dtype=np.uint8)
    for i, row in zip(rows, wires):
        for w, wire in enumerate(row):
            buf[w, i, : len(wire)] = np.frombuffer(
                b"".join(v.to_bytes(32, "little") for v in wire), np.uint8
            ).reshape(-1, 32)
    return buf.view("<i4")


def make_prove_request(
    d: int, k: int, seed: int, pub_list_extra: list[int], toggle_pos: int
) -> ProveRequest:
    """Test/bench helper: derive consistent (y, y_inv, q, z_img) the way the
    canonical Go client does, inserting the prover's own bid into the list."""
    consts = mimc_constants()
    m = mimc_hash(k, 0, consts)
    x = mimc_hash(d, m, consts)
    y = mimc_hash(seed, x, consts)
    z = mimc_hash(seed, m, consts)
    y_inv = scalar_invert(y)
    pub_list = list(pub_list_extra)
    pub_list.insert(toggle_pos, x)
    return ProveRequest(
        d=d, k=k, y=y, y_inv=y_inv, q=d * y_inv % L, z_img=z, seed=seed,
        pub_list=pub_list, toggle=toggle_pos,
    )


def _publics_limbs(reqs_publics: list[list[int]]) -> np.ndarray:
    B = len(reqs_publics)
    npub = len(reqs_publics[0])
    return limb.ints_to_limbs_fast(
        [v % L for row in reqs_publics for v in row], (B, npub)
    )


def check_list_len(list_len: int) -> None:
    """Refuse a bid list from its length alone: ValueError if it is empty,
    ProofError if its circuit's n_pad exceeds the generator capacity.  It
    synthesizes nothing, so a list of any length is refused at once."""
    check_capacity(blindbid_n_pad(list_len), GENS_CAPACITY)


def _checked_circuit(list_len: int, device, mesh) -> CompiledCircuit:
    """The circuit of `list_len` bids on the device of the pass, made only
    after `check_list_len` and before the prover or verifier, so a refused
    request synthesizes nothing, builds no table and launches nothing.  The
    synthesized circuit is held to the capacity again."""
    check_list_len(list_len)
    circuit = blindbid_circuit(list_len, device if mesh is None else mesh.device)
    check_capacity(circuit.n_pad, GENS_CAPACITY)
    return circuit


def prove_batch(
    requests: list[ProveRequest],
    rng: np.random.Generator | None = None,
    seed: bytes = b"\x00" * 32,
    device=None,
    mesh=None,
) -> list[BlindBidProof]:
    """Prove a batch of same-list-length requests in transcript lockstep.

    With a mesh, the blindings of the whole batch are rank 0's draws from its
    `rng` (B x m in batch order), broadcast, so every rank proves with the
    numbers one process would draw."""
    with span("app.prove_batch"):
        if mesh is None:
            device = resolve_device(device)  # first: without a GPU, no work
        B = len(requests)
        list_len = len(requests[0].pub_list)
        if any(len(r.pub_list) != list_len for r in requests):
            raise ValueError("batch must share list length")
        with span("app.circuit"):
            circuit = _checked_circuit(list_len, device, mesh)
        for r in requests:
            if not 0 <= r.toggle < list_len:
                raise ValueError("toggle out of range")
        rng = rng or np.random.default_rng()

        transcripts = [Transcript(TRANSCRIPT_LABEL) for _ in range(B)]
        prover = Prover(transcripts, cap=GENS_CAPACITY, device=device, mesh=mesh)

        m = circuit.m
        values = [
            [r.d, r.k, r.y, r.y_inv] + [1 if i == r.toggle else 0 for i in range(list_len)]
            for r in requests
        ]
        blind_ints = None
        if mesh is None or mesh.rank == 0:
            with span("app.blindings"):
                blind_ints = [
                    [int.from_bytes(rng.bytes(32), "little") % L for _ in range(m)]
                    for _ in range(B)
                ]
        if mesh is not None:
            blind_ints = pmesh.broadcast_object(mesh, blind_ints)
        commitments = prover.commit_batch(values, blind_ints)

        n_pad = circuit.n_pad
        rows = range(B)[prover.rows]  # the rows the prover reads
        with span("app.witness"):
            wires = [blindbid_witness(requests[i]) for i in rows]
        with span("app.witness_words"):
            aL, aR, aO = witness_words(wires, rows, B, n_pad)
            v = limb.ints_to_limbs_fast([v % L for row in values for v in row], (B, m))
            v_blinding = limb.ints_to_limbs_fast([g for row in blind_ints for g in row], (B, m))
        with span("app.publics"):
            publics = _publics_limbs(
                [[r.q, r.z_img, r.seed] + list(r.pub_list) for r in requests]
            )
        witness = ProverWitness(a_L=aL, a_R=aR, a_O=aO, v=v, v_blinding=v_blinding,
                                publics=publics)
        r1cs_proofs = prover.prove(circuit, witness, seed=seed)
        return [
            BlindBidProof(r1cs=p, commitments=commitments[i][:4], t_c=commitments[i][4:])
            for i, p in enumerate(r1cs_proofs)
        ]


def verify_batch(requests: list[VerifyRequest], device=None, mesh=None) -> list[bool]:
    """Verify a batch of same-shape requests (`mesh`: see prove_batch)."""
    with span("app.verify_batch"):
        if mesh is None:
            device = resolve_device(device)  # first: without a GPU, no work
        B = len(requests)
        list_len = len(requests[0].pub_list)
        if any(len(r.pub_list) != list_len for r in requests):
            raise ValueError("batch must share list length")
        with span("app.circuit"):
            circuit = _checked_circuit(list_len, device, mesh)

        transcripts = [Transcript(TRANSCRIPT_LABEL) for _ in range(B)]
        verifier = Verifier(transcripts, cap=GENS_CAPACITY, device=device, mesh=mesh)
        commitments = [r.proof.commitments + r.proof.t_c for r in requests]
        for row in commitments:
            if len(row) != 4 + list_len:
                raise ValueError("commitment count does not match list length")
        verifier.commit_batch(commitments)
        with span("app.publics"):
            publics = _publics_limbs(
                [[r.score, r.z_img, r.seed] + list(r.pub_list) for r in requests]
            )
        return verifier.verify(
            circuit, [r.proof.r1cs for r in requests], commitments, publics
        )


def proof_blob(proof: BlindBidProof) -> bytes:
    """Commitments, toggle commitments, then the R1CS proof bytes: the
    layout of the frozen full-size vector in tests/data."""
    return b"".join(proof.commitments) + b"".join(proof.t_c) + proof.r1cs.to_bytes()


def proof_from_blob(blob: bytes, list_len: int) -> BlindBidProof:
    """Inverse of `proof_blob` for a list of `list_len` items."""
    head = [blob[32 * i : 32 * (i + 1)] for i in range(4 + list_len)]
    return BlindBidProof(
        r1cs=R1CSProof.from_bytes(blob[32 * (4 + list_len) :]),
        commitments=head[:4],
        t_c=head[4:],
    )
