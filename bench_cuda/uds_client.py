"""The bidders of the served cell: a process of its own that speaks wire bytes
alone to the daemon's Unix socket, as a Dusk node's Go client does.

    python3 bench_cuda/uds_client.py <parameters.json>

It imports numpy, `bench_cuda.traffic` and `bench_cuda.reference` only:
nothing of the port and no torch.  The parameters (a JSON object) are the
socket's path, the seed, the list length, the window's seconds, the file to
write the sessions to, and the cell's traffic:

  connections       bidders in closed loop, a connection each;
  stagger_s         each connection's first session starts at an offset
                    drawn uniform over the window's first `stagger_s`;
  think_ms_mean     the mean of the exponential pause before each next
                    session;
  distinct_sessions bidder statements drawn in set-up (`traffic.bidders`),
                    their prove frames built once and used in turn;
  altered_every     one session in this many, at a place drawn from the
                    seed, sends its proof back with t_x + 1
                    (`traffic.tampered`): its verdict must be 0x00.

A session is one opcode-1 prove, then one opcode-2 verify of the proof that
came back.  Every session that starts inside the window runs to its end.  No
wait for an answer lasts longer than `answer_timeout_s`; an answer that never
comes or is the error frame leaves the session without a proof or a verdict,
and a connection whose answer never came is closed and starts no further
session.

Set-up ends with one warm-up session of its own statement; the process then
prints one JSON line ({"ready": seconds}) and waits for a line on its
standard input before it opens the window.  At the end it writes the
sessions, in the order they started, and prints {"done": sessions}.
"""

from __future__ import annotations

import asyncio
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_cuda import traffic  # noqa: E402
from bench_cuda.reference import wire  # noqa: E402


async def read_answer(reader: asyncio.StreamReader) -> bytes:
    """The payload of the next frame on the connection."""
    head = b""
    while True:
        head += await reader.readexactly(1)
        if not head[-1] & 0x80:
            break
        if len(head) > 9:
            raise wire.WireError("varint too long")
    n, _ = wire.read_varint(head, 0)
    return await reader.readexactly(n)


class Session:
    """One prove and verify; `run` fills in what came back."""

    def __init__(self, index: int, statement: int, tampered: bool):
        self.index, self.statement, self.tampered = index, statement, tampered
        self.r1cs = self.commitments = self.toggles = self.verdict = None
        self.start = self.end = None

    async def run(self, conn, bidder: dict, prove_frame: bytes, timeout: float) -> bool:
        """False if the connection can carry no further session."""
        reader, writer = conn
        self.start = time.perf_counter()
        try:
            writer.write(prove_frame)
            await writer.drain()
            answer = await asyncio.wait_for(read_answer(reader), timeout)
            if answer == wire.ERROR:
                return True
            r1cs, self.commitments, self.toggles = wire.parse_envelope(answer)
            self.r1cs = traffic.tampered(r1cs) if self.tampered else r1cs
            writer.write(wire.request(wire.OP_VERIFY, wire.verify_body(
                self.r1cs, self.commitments, self.toggles, bidder)))
            await writer.drain()
            answer = await asyncio.wait_for(read_answer(reader), timeout)
            self.verdict = {wire.VALID: True, wire.INVALID: False}.get(answer)
            return True
        except (asyncio.TimeoutError, asyncio.IncompleteReadError, ConnectionError,
                wire.WireError) as exc:
            print(f"uds_client: session {self.index}: {type(exc).__name__} {exc}",
                  file=sys.stderr, flush=True)
            return False
        finally:
            self.end = time.perf_counter()

    def record(self) -> dict:
        hexes = (lambda xs: None if xs is None else [x.hex() for x in xs])
        return {"index": self.index, "statement": self.statement, "tampered": self.tampered,
                "r1cs": None if self.r1cs is None else self.r1cs.hex(),
                "commitments": hexes(self.commitments), "toggles": hexes(self.toggles),
                "verdict": self.verdict, "start": self.start, "end": self.end}


class Bidders:
    def __init__(self, p: dict):
        tr = p["traffic"]
        self.p, self.tr = p, tr
        self.timeout = p["answer_timeout_s"]
        self.statements = traffic.bidders(p["seed"], "sessions", tr["distinct_sessions"],
                                          p["list_len"])
        self.frames = [wire.request(wire.OP_PROVE, wire.prove_body(b))
                       for b in self.statements]
        self.warm = traffic.bidders(p["seed"], "warm", 1, p["list_len"])[0]
        self.sessions: list[Session] = []
        self._altered = traffic.rng(p["seed"], "altered")
        self._blocks: list[int] = []

    async def connect(self):
        return await asyncio.open_unix_connection(self.p["socket"])

    def _next(self) -> Session:
        """The next session, in the order sessions start: its statement in
        turn, and whether it is the altered one of its block."""
        k, every = len(self.sessions), self.tr["altered_every"]
        while len(self._blocks) <= k // every:
            self._blocks.append(int(self._altered.integers(0, every)))
        s = Session(k, k % len(self.statements), self._blocks[k // every] == k % every)
        self.sessions.append(s)
        return s

    async def warm_up(self) -> None:
        conn = await self.connect()
        s = Session(-1, -1, False)
        frame = wire.request(wire.OP_PROVE, wire.prove_body(self.warm))
        await s.run(conn, self.warm, frame, self.timeout)
        conn[1].close()
        if s.verdict is not True:
            raise SystemExit(f"uds_client: the warm-up session failed: {s.record()}")

    async def bidder(self, c: int, start: float, offset: float) -> None:
        think = traffic.rng(self.p["seed"], f"think{c}")
        conn = await self.connect()
        try:
            await asyncio.sleep(max(0.0, start + offset - time.perf_counter()))
            while time.perf_counter() - start < self.p["seconds"]:
                s = self._next()
                if not await s.run(conn, self.statements[s.statement],
                                   self.frames[s.statement], self.timeout):
                    return
                await asyncio.sleep(think.exponential(self.tr["think_ms_mean"] / 1e3))
        finally:
            conn[1].close()

    async def window(self) -> None:
        n = self.tr["connections"]
        offsets = traffic.rng(self.p["seed"], "stagger").uniform(0.0, self.tr["stagger_s"], n)
        start = time.perf_counter()
        await asyncio.gather(*(self.bidder(c, start, float(offsets[c])) for c in range(n)))


async def main(path: str) -> int:
    t0 = time.perf_counter()
    p = json.loads(Path(path).read_text())
    bidders = Bidders(p)
    await bidders.warm_up()
    print(json.dumps({"ready": time.perf_counter() - t0}), flush=True)
    loop = asyncio.get_running_loop()
    await loop.run_in_executor(None, sys.stdin.readline)
    await bidders.window()
    Path(p["out"]).write_text(json.dumps([s.record() for s in bidders.sessions]))
    print(json.dumps({"done": len(bidders.sessions)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(asyncio.run(main(sys.argv[1])))
