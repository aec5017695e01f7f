"""Unified error type — behavioral port of /root/reference/src/error.rs:18-25.

The reference folds every failure domain into one enum
``Error{Io, Other, R1CS, Tlv, UnexpectedEof}`` with ``From`` impls
(error.rs:61-63) so the dispatch layer can answer any failure with a single
error frame (futures/main.rs:15-25).  Here the same role is played by one
exception hierarchy: the server's dispatch catches ``BlindBidError`` (or any
``Exception``) and answers the TLV error frame, keeping the daemon alive
(per-request error containment, SURVEY.md §5).
"""

from __future__ import annotations


class BlindBidError(Exception):
    """Base of the unified error domain (error.rs:18-25)."""


class IoError(BlindBidError, OSError):
    """Transport / socket failures (error.rs Io variant)."""


class TlvError(BlindBidError, ValueError):
    """Wire-codec framing failures (error.rs Tlv variant).  Also a
    ``ValueError`` so pre-existing codec call sites keep catching it."""


class R1CSError(BlindBidError):
    """Proof-system failures: malformed proofs, verification errors
    (error.rs R1CS variant; bulletproofs R1CSError)."""


class UnexpectedEof(BlindBidError, EOFError):
    """Short reads mid-frame (error.rs UnexpectedEof variant,
    error.rs:28-37 helper).  Also an ``EOFError`` for legacy catches."""


class OtherError(BlindBidError):
    """Catch-all with a message (error.rs Other variant)."""


def wrap_exception(exc: Exception) -> BlindBidError:
    """``From`` impl analog (error.rs:61-63): map foreign exceptions into the
    unified domain."""
    from .models.transcript_protocol import ProofError

    if isinstance(exc, BlindBidError):
        return exc
    if isinstance(exc, ProofError):
        return R1CSError(str(exc))
    if isinstance(exc, EOFError):
        return UnexpectedEof(str(exc))
    if isinstance(exc, (ConnectionError, OSError)):
        return IoError(str(exc))
    if isinstance(exc, ValueError):
        return OtherError(str(exc))
    return OtherError(f"{type(exc).__name__}: {exc}")
