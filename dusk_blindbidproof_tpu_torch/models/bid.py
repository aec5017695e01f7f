"""Bid: one entry of the public bid list, as it travels on the wire.

A bid wraps one scalar, built from a raw 32-byte entry with
``Scalar::from_bits`` semantics: the top bit is masked off and there is NO
canonical reduction mod l.  A 255-bit value at or above l is accepted as it
is and goes into the request's `pub_list` unreduced; everything downstream
computes mod l (`models.blindbid` reduces where it makes limbs).

Only 32-byte entries decode: any other length raises ``ValueError``, the
observable contract of the original daemon, where such an entry is fatal.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.tlv import TlvReader


def scalar_from_bits(data: bytes) -> int:
    """``Scalar::from_bits``: mask bit 255, no canonical reduction."""
    if len(data) != 32:
        raise ValueError(f"bid entries must be 32 bytes, got {len(data)}")
    return int.from_bytes(data, "little") & ((1 << 255) - 1)


@dataclass(frozen=True)
class Bid:
    """One public-list entry."""

    x: int  # raw 255-bit value, possibly >= l (from_bits semantics)

    @staticmethod
    def from_bytes(data: bytes) -> "Bid":
        return Bid(scalar_from_bits(data))

    @staticmethod
    def try_list_from_reader(reader: TlvReader) -> list["Bid"]:
        """TLV list of 32-byte entries -> bids."""
        return [Bid.from_bytes(item) for item in reader.read_list()]

    def to_bytes(self) -> bytes:
        return self.x.to_bytes(32, "little")
