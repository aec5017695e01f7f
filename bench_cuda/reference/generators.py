"""Pedersen and Bulletproofs generators, derived on the host from their labels.

A frozen copy of the port's generator derivation (the `bulletproofs`
crate's `GeneratorsChain`: SHAKE-256 read 64 bytes at a time through the
ristretto one-way map, labels ``G``/``H`` and the party index).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache

from .curve import (
    ED25519_BASEPOINT,
    EdwardsPoint,
    ristretto_compress,
    ristretto_from_uniform_bytes,
)


class GeneratorsChain:
    """SHAKE-256 XOF chain: each generator reads 64 bytes -> one-way map."""

    def __init__(self, label: bytes):
        shake = hashlib.shake_256()
        shake.update(b"GeneratorsChain")
        shake.update(label)
        # hashlib's shake has no incremental reader; materialize a long
        # digest and slice.  4096 generators * 64B = 256 KiB is nothing.
        self._buf = b""
        self._shake = shake
        self._off = 0

    def _read(self, n: int) -> bytes:
        while self._off + n > len(self._buf):
            # Re-digest with doubled length; XOF prefixes are stable.
            want = max(1 << 16, 2 * (self._off + n))
            self._buf = self._shake.digest(want)
        out = self._buf[self._off : self._off + n]
        self._off += n
        return out

    def next_point(self) -> EdwardsPoint:
        return ristretto_from_uniform_bytes(self._read(64))


@dataclass(frozen=True)
class PedersenGens:
    B: EdwardsPoint
    B_blinding: EdwardsPoint

    def commit(self, value: int, blinding: int) -> EdwardsPoint:
        return self.B.scalar_mul(value) + self.B_blinding.scalar_mul(blinding)

    @staticmethod
    @lru_cache(maxsize=1)
    def default() -> "PedersenGens":
        basepoint_bytes = ristretto_compress(ED25519_BASEPOINT)
        uniform = hashlib.sha3_512(basepoint_bytes).digest()
        return PedersenGens(
            B=ED25519_BASEPOINT,
            B_blinding=ristretto_from_uniform_bytes(uniform),
        )


class BulletproofGens:
    """G/H generator vectors, gens_capacity per party.

    BlindBid instantiates (gens_capacity=2048, party_capacity=1).
    """

    def __init__(self, gens_capacity: int, party_capacity: int = 1):
        self.gens_capacity = gens_capacity
        self.party_capacity = party_capacity
        self.G_vec: list[list[EdwardsPoint]] = []
        self.H_vec: list[list[EdwardsPoint]] = []
        for party in range(party_capacity):
            label = party.to_bytes(4, "little")
            g_chain = GeneratorsChain(b"G" + label)
            h_chain = GeneratorsChain(b"H" + label)
            self.G_vec.append([g_chain.next_point() for _ in range(gens_capacity)])
            self.H_vec.append([h_chain.next_point() for _ in range(gens_capacity)])

    def share(self, party: int) -> tuple[list[EdwardsPoint], list[EdwardsPoint]]:
        return self.G_vec[party], self.H_vec[party]


@lru_cache(maxsize=4)
def cached_bp_gens(gens_capacity: int, party_capacity: int = 1) -> BulletproofGens:
    return BulletproofGens(gens_capacity, party_capacity)
