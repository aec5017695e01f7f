"""The one traffic generator: everything a cell sends is drawn here from its
seed and the parameters of its cell file.

Streams.  A run draws from several independent numpy generators, each keyed
by (seed, stream name), so the warm-up never shares a draw with the window
and the reference's sample never shifts the traffic.

Bidders.  A bidder of a list of `list_len` bids draws its secrets d and k,
the round's seed, the other bids of its list (uniform scalars) and its own
place in the list; its client derives the rest (`reference.circuits.bidder`).
"""

from __future__ import annotations

import zlib

import numpy as np

from .reference.circuits import bidder
from .reference.curve import L


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([seed % 2**64, zlib.crc32(stream.encode())])


def scalar(gen: np.random.Generator) -> int:
    return int.from_bytes(gen.bytes(32), "little") % L


def bidders(seed: int, stream: str, count: int, list_len: int) -> list[dict]:
    gen = rng(seed, stream)
    out = []
    for _ in range(count):
        d, k, round_seed = scalar(gen), scalar(gen), scalar(gen)
        others = [scalar(gen) for _ in range(list_len - 1)]
        pos = int(gen.integers(0, list_len))
        out.append(bidder(d, k, round_seed, others, pos))
    return out


def picks(seed: int, stream: str, population: int, count: int) -> list[int]:
    """`count` distinct indices of `population`, drawn from the seed."""
    gen = rng(seed, stream)
    return sorted(int(i) for i in gen.choice(population, size=min(count, population),
                                             replace=False))


def tampered(proof_bytes: bytes) -> bytes:
    """The proof with t_x plus one (mod l): well formed, and invalid wherever
    the proof it came from is valid."""
    out = bytearray(proof_bytes)
    off = 1 + 32 * 8  # version byte, A_I1 A_O1 S1, T_1 T_3 T_4 T_5 T_6
    t_x = int.from_bytes(out[off:off + 32], "little")
    out[off:off + 32] = ((t_x + 1) % L).to_bytes(32, "little")
    return bytes(out)
