"""Keccak-f[1600] permutation (host side).

The Fiat-Shamir transcript of the proof system is a STROBE-128 duplex over
Keccak-f[1600] (reference: `merlin` 1.3.0 over the `keccak` crate,
/root/reference/Cargo.lock:399-407,366; used via
`Transcript::new(b"BlindBidProofGadget")` at /root/reference/src/blindbid/mod.rs:37).

The transcript is inherently sequential, tiny (microseconds per proof) and must
be *bit-exact*, so it lives on the host in pure Python.  Correctness is
validated in tests by building SHA3-256 on top of this permutation and
comparing against `hashlib`.
"""

from __future__ import annotations

_MASK64 = (1 << 64) - 1

# Round constants for the 24 rounds of Keccak-f[1600] (FIPS 202 §3.2.5).
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y] (FIPS 202 §3.2.2), flattened as lane index x + 5*y.
_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]


def _rotl(v: int, r: int) -> int:
    return ((v << r) | (v >> (64 - r))) & _MASK64


def keccak_f1600(lanes: list[int]) -> list[int]:
    """Apply Keccak-f[1600] to 25 64-bit lanes (lane index = x + 5*y)."""
    a = list(lanes)
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                # B[y, 2x+3y] = rot(A[x, y])
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x + 5 * y])
        # chi
        a = [
            b[i] ^ ((~b[(i % 5 + 1) % 5 + 5 * (i // 5)]) & b[(i % 5 + 2) % 5 + 5 * (i // 5)] & _MASK64)
            for i in range(25)
        ]
        # iota
        a[0] ^= rc
    return a


def keccak_f1600_bytes(state: bytearray) -> None:
    """Apply Keccak-f[1600] in place to a 200-byte state (little-endian lanes)."""
    lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]
    lanes = keccak_f1600(lanes)
    for i, lane in enumerate(lanes):
        state[8 * i : 8 * i + 8] = lane.to_bytes(8, "little")


def sha3_256(data: bytes) -> bytes:
    """SHA3-256 built on keccak_f1600 — used only to validate the permutation."""
    rate = 136
    state = bytearray(200)
    # absorb with pad10*1, domain 0x06
    padded = bytearray(data)
    padded.append(0x06)
    while len(padded) % rate != 0:
        padded.append(0x00)
    padded[-1] ^= 0x80
    for off in range(0, len(padded), rate):
        for i in range(rate):
            state[i] ^= padded[off + i]
        keccak_f1600_bytes(state)
    return bytes(state[:32])
