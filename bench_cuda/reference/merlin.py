"""Merlin transcripts (STROBE-128 over Keccak-f[1600]) in pure Python.

A frozen copy of the port's host transcript, without its native duplex:
the reference replays a verifier's transcript, and forks the prover's into
the blinding RNG (`Transcript.build_rng`) to make the draws a proof's bytes
follow from.
"""

from __future__ import annotations

from .keccak import keccak_f1600_bytes

STROBE_R = 166  # rate in bytes for security level 128: 200 - 32 - 2

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


class Strobe128:
    """Minimal STROBE-128 duplex exactly as implemented inside merlin 1.3.0."""

    __slots__ = ("state", "pos", "pos_begin", "cur_flags")

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        keccak_f1600_bytes(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- internal duplex ops ------------------------------------------------
    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        keccak_f1600_bytes(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] ^= byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _squeeze(self, n: int) -> bytes:
        out = bytearray(n)
        for i in range(n):
            out[i] = self.state[self.pos]
            self.state[self.pos] = 0
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()
        return bytes(out)

    def _overwrite(self, data: bytes) -> None:
        for byte in data:
            self.state[self.pos] = byte
            self.pos += 1
            if self.pos == STROBE_R:
                self._run_f()

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            if flags != self.cur_flags:
                raise ValueError(
                    f"continued op with changed flags: {flags} != {self.cur_flags}"
                )
            return
        if flags & FLAG_T:
            raise ValueError("transport ops are not implemented")
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- public STROBE ops (the subset merlin uses) -------------------------
    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)

    def clone(self) -> "Strobe128":
        s = type(self).__new__(type(self))
        s.state = bytearray(self.state)
        s.pos = self.pos
        s.pos_begin = self.pos_begin
        s.cur_flags = self.cur_flags
        return s


def _u32_le(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    """merlin::Transcript equivalent."""

    MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = Strobe128(self.MERLIN_PROTOCOL_LABEL)
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

    def clone(self) -> "Transcript":
        t = Transcript.__new__(Transcript)
        t.strobe = self.strobe.clone()
        return t

    def build_rng(self) -> "TranscriptRngBuilder":
        return TranscriptRngBuilder(self.strobe.clone())


class TranscriptRngBuilder:
    """merlin::TranscriptRngBuilder: witness bytes keyed into a fork of the
    transcript, then the external seed."""

    def __init__(self, strobe: Strobe128):
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
    def __init__(self, strobe: Strobe128):
        self.strobe = strobe

    def fill_bytes(self, n: int) -> bytes:
        self.strobe.meta_ad(_u32_le(n), False)
        return self.strobe.prf(n, False)
