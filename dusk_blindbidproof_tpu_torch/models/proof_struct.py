"""R1CS proof container + byte serialization.

Byte layout follows the pinned bulletproofs crate's `R1CSProof::to_bytes`
(dep pinned at /root/reference/Cargo.lock:65-67; consumed by the reference at
/root/reference/src/blindbid/proof.rs:118-143 and 145-183):

    [version: u8]            0 = one-phase (A_I2/A_O2/S2 omitted, all identity)
                             1 = two-phase (they are present)
    A_I1 A_O1 S1 [A_I2 A_O2 S2]   32-byte compressed Ristretto each
    T_1 T_3 T_4 T_5 T_6           32 bytes each
    t_x t_x_blinding e_blinding   32-byte scalars
    L_0 R_0 L_1 R_1 ... a b       inner-product proof (interleaved rounds)

The BlindBid circuit always uses the one-phase protocol (the 2-phase
randomized-constraint API exists but is unused — SURVEY.md §2.2 bulletproofs
row), so serialization emits version 0.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.curve_host import L
from .transcript_protocol import IDENTITY_COMPRESSED, ProofError

ONE_PHASE = 0
TWO_PHASE = 1


def _scalar_bytes(s: int) -> bytes:
    return (s % L).to_bytes(32, "little")


def _read_scalar(b: bytes) -> int:
    s = int.from_bytes(b, "little")
    if s >= L:
        raise ProofError("non-canonical scalar in proof")
    return s


@dataclass
class R1CSProof:
    A_I1: bytes
    A_O1: bytes
    S1: bytes
    A_I2: bytes
    A_O2: bytes
    S2: bytes
    T_1: bytes
    T_3: bytes
    T_4: bytes
    T_5: bytes
    T_6: bytes
    t_x: int
    t_x_blinding: int
    e_blinding: int
    ipp_L: list[bytes]
    ipp_R: list[bytes]
    ipp_a: int
    ipp_b: int

    def missing_phase2(self) -> bool:
        return (
            self.A_I2 == IDENTITY_COMPRESSED
            and self.A_O2 == IDENTITY_COMPRESSED
            and self.S2 == IDENTITY_COMPRESSED
        )

    def to_bytes(self) -> bytes:
        out = bytearray()
        if self.missing_phase2():
            out.append(ONE_PHASE)
            points = [self.A_I1, self.A_O1, self.S1]
        else:
            out.append(TWO_PHASE)
            points = [self.A_I1, self.A_O1, self.S1, self.A_I2, self.A_O2, self.S2]
        points += [self.T_1, self.T_3, self.T_4, self.T_5, self.T_6]
        for p in points:
            assert len(p) == 32
            out += p
        out += _scalar_bytes(self.t_x)
        out += _scalar_bytes(self.t_x_blinding)
        out += _scalar_bytes(self.e_blinding)
        for l, r in zip(self.ipp_L, self.ipp_R):
            out += l
            out += r
        out += _scalar_bytes(self.ipp_a)
        out += _scalar_bytes(self.ipp_b)
        return bytes(out)

    @staticmethod
    def from_bytes(data: bytes) -> "R1CSProof":
        if len(data) < 1 + 32:
            raise ProofError("proof too short")
        version = data[0]
        if version not in (ONE_PHASE, TWO_PHASE):
            raise ProofError(f"unknown proof format version {version}")
        body = data[1:]
        if len(body) % 32 != 0:
            raise ProofError("proof body not a multiple of 32 bytes")
        chunks = [bytes(body[i : i + 32]) for i in range(0, len(body), 32)]
        n_head = 3 if version == ONE_PHASE else 6
        if len(chunks) < n_head + 5 + 3 + 2:
            raise ProofError("proof too short")
        head = chunks[:n_head]
        if version == ONE_PHASE:
            a_i1, a_o1, s1 = head
            a_i2 = a_o2 = s2 = IDENTITY_COMPRESSED
        else:
            a_i1, a_o1, s1, a_i2, a_o2, s2 = head
        t1, t3, t4, t5, t6 = chunks[n_head : n_head + 5]
        t_x = _read_scalar(chunks[n_head + 5])
        t_x_blinding = _read_scalar(chunks[n_head + 6])
        e_blinding = _read_scalar(chunks[n_head + 7])
        ipp = chunks[n_head + 8 :]
        if len(ipp) < 2 or (len(ipp) - 2) % 2 != 0:
            raise ProofError("malformed inner-product proof")
        rounds = (len(ipp) - 2) // 2
        ipp_L = [ipp[2 * i] for i in range(rounds)]
        ipp_R = [ipp[2 * i + 1] for i in range(rounds)]
        ipp_a = _read_scalar(ipp[-2])
        ipp_b = _read_scalar(ipp[-1])
        return R1CSProof(
            a_i1, a_o1, s1, a_i2, a_o2, s2, t1, t3, t4, t5, t6,
            t_x, t_x_blinding, e_blinding, ipp_L, ipp_R, ipp_a, ipp_b,
        )


@dataclass
class BlindBidProof:
    """The reference's outer `Proof` (proof.rs:17-21): the R1CS proof plus the
    high-level commitments [d, k, y, y_inv] and the toggle commitments."""

    r1cs: R1CSProof
    commitments: list[bytes]  # 4 x 32B
    t_c: list[bytes]  # L x 32B
