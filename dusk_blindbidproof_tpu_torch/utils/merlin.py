"""Merlin transcripts (STROBE-128 over Keccak-f[1600]), host side.

Re-implements the behavior of the `merlin` 1.3.0 crate pinned by the reference
(/root/reference/Cargo.lock:399-407): a STROBE-128 duplex construction with
security parameter 128 (rate R = 166), protocol label ``b"Merlin v1.0"``, and
the `append_message` / `challenge_bytes` framing (each prefixed by a meta-AD of
the label and a little-endian u32 length).

The reference creates its proof transcript as
``Transcript::new(b"BlindBidProofGadget")`` (/root/reference/src/blindbid/mod.rs:37);
the Bulletproofs layers `TranscriptProtocol` on top (see
dusk_blindbidproof_tpu.models.transcript_protocol).

All transcript state lives on the host: it is a few hundred bytes and strictly
sequential; device phases exchange only commitment bytes / challenge scalars
with it (SURVEY.md §7 "Fiat-Shamir host<->device ping-pong").  The duplex is
the native C++ core (`utils/native.py`); importing this module raises where
that core cannot be loaded.
"""

from __future__ import annotations

from .native import NativeStrobe128


def _u32_le(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    """merlin::Transcript equivalent."""

    MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = NativeStrobe128(self.MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32_le(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, x.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32_le(n), True)
        return self.strobe.prf(n, False)

    def build_rng(self) -> "TranscriptRngBuilder":
        return TranscriptRngBuilder(self.strobe.clone())

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t.strobe = self.strobe.clone()
        return t


class TranscriptRngBuilder:
    """merlin::TranscriptRngBuilder — binds witness data into a forked STROBE
    state, then keys it with external entropy to produce a deterministic
    (given the seed) blinding RNG.  Used for Pedersen blinding factors so that
    proofs are reproducible test vectors when seeded (SURVEY.md §2.2 rand row).
    """

    def __init__(self, strobe: NativeStrobe128):
        self.strobe = strobe

    def rekey_with_witness_bytes(self, label: bytes, witness: bytes) -> "TranscriptRngBuilder":
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32_le(len(witness)), True)
        self.strobe.key(witness, False)
        return self

    def finalize(self, rng_seed: bytes) -> "TranscriptRng":
        if len(rng_seed) != 32:
            raise ValueError("rng seed must be 32 bytes")
        self.strobe.meta_ad(b"rng", False)
        self.strobe.key(rng_seed, False)
        return TranscriptRng(self.strobe)


class TranscriptRng:
    def __init__(self, strobe: NativeStrobe128):
        self.strobe = strobe

    def fill_bytes(self, n: int) -> bytes:
        self.strobe.meta_ad(_u32_le(n), False)
        return self.strobe.prf(n, False)
