"""BlindBid protocol constants.

MIMC_CONSTANTS reproduces /root/reference/src/blindbid/mod.rs:7-24 exactly:
90 scalars derived by a chained SHA-512 starting from Sha512(b"blind bid");
each constant is the wide (64-byte) mod-order reduction of the running hash,
and the next hash is taken over the 32-byte canonical encoding of the
previous constant.  This is first-party reference behavior, so it is a
bit-exactness gate (tests pin the first/last values).
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

from ..utils.curve_host import scalar_from_bytes_mod_order_wide, scalar_to_bytes

MIMC_ROUNDS = 90
TRANSCRIPT_LABEL = b"BlindBidProofGadget"  # mod.rs:37
GENS_CAPACITY = 2048  # BulletproofGens::new(2048, 1), mod.rs:36


@lru_cache(maxsize=1)
def mimc_constants() -> tuple[int, ...]:
    out = []
    h = hashlib.sha512(b"blind bid").digest()
    for _ in range(MIMC_ROUNDS):
        c = scalar_from_bytes_mod_order_wide(h)
        out.append(c)
        h = hashlib.sha512(scalar_to_bytes(c)).digest()
    return tuple(out)
