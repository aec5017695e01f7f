"""Pedersen / Bulletproof generator setup (host side, computed once).

Re-implements the `bulletproofs` crate's generators module behavior
(pinned dep, /root/reference/Cargo.lock:65-67), used by the reference as
``BulletproofGens::new(2048, 1)`` + ``PedersenGens::default()``
(/root/reference/src/blindbid/mod.rs:34-40):

  * ``PedersenGens``: B = ristretto255 basepoint; B_blinding =
    ``RistrettoPoint::hash_from_bytes::<Sha3_512>(B.compress().as_bytes())``.
  * ``BulletproofGens``: per-party G/H vectors drawn from a SHAKE-256
    ``GeneratorsChain`` seeded with labels ``b"GeneratorsChain" || b'G'/b'H'
    || party_index_u32_le``; each generator consumes 64 XOF bytes through the
    ristretto one-way map (``from_uniform_bytes``).

The reference rebuilds these on every request (/root/reference/src/blindbid/
mod.rs:34-40 called from proof.rs:47 / verify.rs:48 — SURVEY.md §8.5 quirk 5).
Here they are computed once per process and cached, both as host points and as
device-resident limb tables (see dusk_blindbidproof_tpu.ops.msm).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from functools import lru_cache

from .curve_host import (
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

    The reference instantiates (gens_capacity=2048, party_capacity=1)
    (/root/reference/src/blindbid/mod.rs:36); party aggregation is the crate's
    unused hook (SURVEY.md §5 long-context analog).
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
