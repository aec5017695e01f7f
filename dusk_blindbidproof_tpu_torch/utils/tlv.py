"""Length-prefixed wire framing (the `dusk-tlv` role).

The protocol frames every request and response; the byte layout here is
the one the recorded sessions in tests/data/session_*.bin were made with:

    frame      := varint(len) || payload                (len = payload bytes)
    write_list := one frame whose payload is the concatenation of the
                  member frames (read_list parses members until exhausted)
    scalars    := 32-byte frames, little-endian
    u64        := 8-byte frame, little-endian

varint = unsigned LEB128.  Failures raise the unified error domain
(errors.TlvError / UnexpectedEof).
"""

from __future__ import annotations

import io

from ..errors import TlvError, UnexpectedEof


def write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def read_varint(stream: io.BufferedIOBase) -> int | None:
    """The next varint of `stream`, or None at a clean end between frames."""
    shift = 0
    value = 0
    while True:
        b = stream.read(1)
        if not b:
            if shift == 0:
                return None
            raise UnexpectedEof("truncated varint")
        byte = b[0]
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value
        shift += 7
        if shift > 63:
            raise TlvError("varint too long")


class TlvWriter:
    def __init__(self, stream=None):
        self.stream = stream if stream is not None else io.BytesIO()

    def write(self, payload: bytes) -> None:
        self.stream.write(write_varint(len(payload)))
        self.stream.write(payload)

    def write_list(self, items: list[bytes]) -> None:
        body = io.BytesIO()
        inner = TlvWriter(body)
        for item in items:
            inner.write(item)
        self.write(body.getvalue())

    def write_scalar(self, s: int) -> None:
        self.write(s.to_bytes(32, "little"))

    def write_u64(self, x: int) -> None:
        self.write(x.to_bytes(8, "little"))

    def getvalue(self) -> bytes:
        return self.stream.getvalue()


class TlvReader:
    def __init__(self, data: bytes | io.BufferedIOBase):
        self.stream = io.BytesIO(data) if isinstance(data, (bytes, bytearray)) else data

    def read_frame(self) -> bytes | None:
        n = read_varint(self.stream)
        if n is None:
            return None
        payload = self.stream.read(n)
        if len(payload) != n:
            raise UnexpectedEof("truncated frame")
        return payload

    def expect_frame(self, what: str = "frame") -> bytes:
        f = self.read_frame()
        if f is None:
            raise UnexpectedEof(f"missing {what}")
        return f

    def read_list(self) -> list[bytes]:
        body = self.expect_frame("list")
        inner = TlvReader(body)
        out = []
        while True:
            f = inner.read_frame()
            if f is None:
                return out
            out.append(f)

    def read_scalar_bytes(self) -> bytes:
        f = self.expect_frame("scalar")
        if len(f) != 32:
            raise TlvError(f"scalar frame must be 32 bytes, got {len(f)}")
        return f

    def read_u64(self) -> int:
        f = self.expect_frame("u64")
        if len(f) != 8:
            raise TlvError(f"u64 frame must be 8 bytes, got {len(f)}")
        return int.from_bytes(f, "little")
