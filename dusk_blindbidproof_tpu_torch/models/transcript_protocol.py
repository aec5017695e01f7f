"""Bulletproofs transcript protocol over Merlin (host side).

Replicates the layering of the pinned `bulletproofs` crate's
TranscriptProtocol (SURVEY.md §8.3): domain separators, labeled point/scalar
appends, and wide-reduced scalar challenges.  The full append/challenge
schedule for the R1CS protocol is frozen here and documented in
models/prover.py; golden challenge-stream vectors live in
tests/test_transcript_protocol.py so any accidental change to the schedule
breaks loudly.
"""

from __future__ import annotations

from ..utils.curve_host import L, scalar_to_bytes
from ..utils.merlin import Transcript


class ProofError(Exception):
    """Verification / malformed-proof error (maps the reference's
    Error::R1CS, /root/reference/src/error.rs:18-25)."""


def r1cs_domain_sep(t: Transcript) -> None:
    t.append_message(b"dom-sep", b"r1cs v1")


def r1cs_1phase_domain_sep(t: Transcript) -> None:
    t.append_message(b"dom-sep", b"r1cs-1phase")


def r1cs_2phase_domain_sep(t: Transcript) -> None:
    t.append_message(b"dom-sep", b"r1cs-2phase")


def innerproduct_domain_sep(t: Transcript, n: int) -> None:
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_u64(b"n", n)


def append_scalar(t: Transcript, label: bytes, s: int) -> None:
    t.append_message(label, scalar_to_bytes(s))


def append_point(t: Transcript, label: bytes, compressed: bytes) -> None:
    assert len(compressed) == 32
    t.append_message(label, compressed)


IDENTITY_COMPRESSED = b"\x00" * 32


def validate_and_append_point(t: Transcript, label: bytes, compressed: bytes) -> None:
    if compressed == IDENTITY_COMPRESSED:
        raise ProofError(f"point {label!r} is the identity")
    append_point(t, label, compressed)


def challenge_scalar(t: Transcript, label: bytes) -> int:
    return int.from_bytes(t.challenge_bytes(label, 64), "little") % L
