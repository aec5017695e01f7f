"""The daemon's wire format, written from the upstream daemon's account of it
(dusk-network/dusk-blindbidproof: the dusk-tlv framing of
`src/futures/main.rs`, the bodies of `src/blindbid/proof.rs:97-183` and
`verify.rs:91-128`), with nothing of the port:

    frame     varint(len) || payload, the varint unsigned LEB128;
    list      one frame whose payload is its members' frames, back to back;
    scalar    a 32-byte frame, little-endian;  u64  an 8-byte frame;
    request   one frame: the opcode byte, then the body;
    prove     (opcode 1) scalars d, k, y, y_inv, q, z_img, seed; a list of
              the bid list's 32-byte entries; the toggle as a u64;
    proof     the envelope the prove answer's frame holds: a frame of the
              R1CS proof's bytes, a list of the 4 commitments and a list of
              the L toggle commitments, each 32 bytes;
    verify    (opcode 2) a frame of a proof envelope; scalars score, z_img,
              seed; the list of the bid list's entries;
    answer    one frame: the envelope (prove), 0x01 or 0x00 (verify), or
              0xff, the error frame, for a request the daemon did not serve.
"""

from __future__ import annotations

OP_PROVE = 1
OP_VERIFY = 2
ERROR = b"\xff"
VALID, INVALID = b"\x01", b"\x00"


class WireError(ValueError):
    pass


def varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append(n & 0x7F | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def read_varint(data: bytes, pos: int) -> tuple[int, int]:
    """(value, position after it) of the varint at `pos`."""
    value = shift = 0
    while True:
        if pos >= len(data):
            raise WireError("truncated varint")
        byte = data[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7
        if shift > 63:
            raise WireError("varint too long")


def frame(payload: bytes) -> bytes:
    return varint(len(payload)) + payload


def frames(data: bytes) -> list[bytes]:
    """Every frame of `data`, which must end at a frame's end."""
    out, pos = [], 0
    while pos < len(data):
        n, pos = read_varint(data, pos)
        if pos + n > len(data):
            raise WireError("truncated frame")
        out.append(data[pos:pos + n])
        pos += n
    return out


def list_frame(items) -> bytes:
    return frame(b"".join(frame(item) for item in items))


def scalar(x: int) -> bytes:
    return frame(x.to_bytes(32, "little"))


def request(opcode: int, body: bytes) -> bytes:
    return frame(bytes([opcode]) + body)


def prove_body(b: dict) -> bytes:
    """The opcode-1 body of a bidder (`circuits.bidder`'s fields)."""
    head = b"".join(scalar(b[k]) for k in ("d", "k", "y", "y_inv", "q", "z_img", "seed"))
    return (head + list_frame(x.to_bytes(32, "little") for x in b["pub_list"])
            + frame(b["toggle"].to_bytes(8, "little")))


def envelope(r1cs: bytes, commitments: list[bytes], toggles: list[bytes]) -> bytes:
    return frame(r1cs) + list_frame(commitments) + list_frame(toggles)


def parse_envelope(payload: bytes) -> tuple[bytes, list[bytes], list[bytes]]:
    """(R1CS proof bytes, commitments, toggle commitments) of a prove answer."""
    parts = frames(payload)
    if len(parts) != 3:
        raise WireError(f"a proof envelope has 3 frames, not {len(parts)}")
    r1cs, commitments, toggles = parts[0], frames(parts[1]), frames(parts[2])
    if any(len(c) != 32 for c in commitments + toggles):
        raise WireError("compressed points must be 32 bytes")
    return r1cs, commitments, toggles


def verify_body(r1cs: bytes, commitments: list[bytes], toggles: list[bytes],
                b: dict) -> bytes:
    """The opcode-2 body that asks for a verdict on a proof of bidder `b`'s
    statement (its score is q)."""
    return (frame(envelope(r1cs, commitments, toggles))
            + b"".join(scalar(b[k]) for k in ("q", "z_img", "seed"))
            + list_frame(x.to_bytes(32, "little") for x in b["pub_list"]))
