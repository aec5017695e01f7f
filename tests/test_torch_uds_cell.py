"""The served cell (`bench_cuda/cells/blindbid-L4-uds.sessions64.json`) on the
CPU, with no prover in the loop:

  * the benchmark's plain wire codec (`bench_cuda/reference/wire.py`, which
    imports nothing of the port) gives the port's bytes (`utils/tlv.py`,
    `server.py`) and the port parses its requests back, both ways;
  * the daemon's `BatchingService` under seeded arrivals: one pass for what
    arrives inside one window, passes of `max_batch` beyond it; the counters
    `server.passes`, `server.requests`, `server.queue_wait_s` and the spans
    `server.decode` / `server.encode`, and nothing of them while spans are
    off; a pass that returns fewer results than requests answers the rest
    the error frame; `run_on_worker` runs a call on the worker thread ahead
    of the passes queued, and the driver reaches a service without it (the
    port before it) the same way;
  * the readers `server.fill.batch` and `server.host_ms.batch`;
  * the client process (`bench_cuda/uds_client.py`) against a stub daemon,
    and the driver (`drivers/uds_closed.py`) against the port's own daemon
    with the device passes replaced, traced on the CPU.
"""

from __future__ import annotations

import asyncio
import io
import json
import logging
import os
import random
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_cuda import harness, traffic, tracing  # noqa: E402
from bench_cuda.drivers import uds_closed  # noqa: E402
from bench_cuda.reference import wire  # noqa: E402
from bench_cuda.reference.curve import L  # noqa: E402
from dusk_blindbidproof_tpu_torch import server as srv  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import blindbid, bulletproofs  # noqa: E402
from dusk_blindbidproof_tpu_torch.models.proof_struct import (  # noqa: E402
    BlindBidProof,
    R1CSProof,
)
from dusk_blindbidproof_tpu_torch.models.transcript_protocol import (  # noqa: E402
    IDENTITY_COMPRESSED,
)
from dusk_blindbidproof_tpu_torch.ops import fused  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils import profiling  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils.tlv import (  # noqa: E402
    TlvReader,
    TlvWriter,
    read_varint,
    write_varint,
)

torch.set_num_threads(1)

SEEDS = [0, 1, 2, 3, 3000000019]
CELL = json.loads((ROOT / "bench_cuda" / "cells" / "blindbid-L4-uds.sessions64.json")
                  .read_text())
CONFIG = json.loads((ROOT / "bench_cuda" / "configs" / "blindbid-L4-uds.json").read_text())
DUMMY_TX = 123


def _reader(name):
    return harness.Finder().module("metrics", name)


def _scalar(gen) -> int:
    return int.from_bytes(gen.bytes(32), "little") % L


def _random_r1cs(gen, rounds: int, t_x: int | None = None) -> R1CSProof:
    point = lambda: gen.bytes(32)  # noqa: E731  (points are not decoded here)
    return R1CSProof(
        A_I1=point(), A_O1=point(), S1=point(), A_I2=IDENTITY_COMPRESSED,
        A_O2=IDENTITY_COMPRESSED, S2=IDENTITY_COMPRESSED, T_1=point(), T_3=point(),
        T_4=point(), T_5=point(), T_6=point(),
        t_x=_scalar(gen) if t_x is None else t_x, t_x_blinding=_scalar(gen),
        e_blinding=_scalar(gen), ipp_L=[point() for _ in range(rounds)],
        ipp_R=[point() for _ in range(rounds)], ipp_a=_scalar(gen), ipp_b=_scalar(gen))


def _random_proof(gen, list_len: int, t_x: int | None = None) -> BlindBidProof:
    return BlindBidProof(r1cs=_random_r1cs(gen, 11, t_x),
                         commitments=[gen.bytes(32) for _ in range(4)],
                         t_c=[gen.bytes(32) for _ in range(list_len)])


# ---------------------------------------------------------------------------
# The reference wire codec against the port's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_the_reference_wire_codec_is_the_ports_byte_for_byte(seed):
    """Varint frames, prove bodies, verify bodies and the proof envelope: the
    reference's bytes are the port's writer's, and each side reads the
    other's back."""
    gen = np.random.default_rng(seed)
    # varints and frames
    for n in [0, 1, 127, 128, 2**14, 2**63 - 1] + [int(x) for x in gen.integers(0, 2**62, 8)]:
        assert wire.varint(n) == write_varint(n)
        assert wire.read_varint(wire.varint(n) + b"tail", 0) == (n, len(write_varint(n)))
        assert read_varint(io.BytesIO(wire.varint(n))) == n
    payloads = [gen.bytes(int(n)) for n in gen.integers(0, 300, 5)]
    w = TlvWriter()
    for p in payloads:
        w.write(p)
    w.write_list(payloads)
    assert b"".join(wire.frame(p) for p in payloads) + wire.list_frame(payloads) == w.getvalue()
    assert wire.frames(w.getvalue())[:5] == payloads
    assert TlvReader(wire.list_frame(payloads)).read_list() == payloads

    # the prove body of a bidder
    list_len = int(gen.integers(1, 9))
    b = traffic.bidders(seed, "wire", 1, list_len)[0]
    w = TlvWriter()
    for k in ("d", "k", "y", "y_inv", "q", "z_img", "seed"):
        w.write_scalar(b[k])
    w.write_list([x.to_bytes(32, "little") for x in b["pub_list"]])
    w.write_u64(b["toggle"])
    assert wire.prove_body(b) == w.getvalue()
    req = srv.parse_prove_request(wire.prove_body(b))
    assert (req.d, req.k, req.y, req.y_inv, req.q, req.z_img, req.seed, req.pub_list,
            req.toggle) == tuple(b[k] for k in ("d", "k", "y", "y_inv", "q", "z_img", "seed",
                                                 "pub_list", "toggle"))
    framed = TlvWriter()
    framed.write(bytes([srv.OP_PROVE]) + w.getvalue())
    assert wire.request(wire.OP_PROVE, wire.prove_body(b)) == framed.getvalue()

    # the proof envelope, both ways
    proof = _random_proof(gen, list_len)
    r1cs = proof.r1cs.to_bytes()
    assert wire.envelope(r1cs, proof.commitments, proof.t_c) == srv.encode_proof(proof)
    assert wire.parse_envelope(srv.encode_proof(proof)) == (r1cs, proof.commitments, proof.t_c)
    assert srv.decode_proof(wire.envelope(r1cs, proof.commitments, proof.t_c)) == proof

    # the verify body
    w = TlvWriter()
    w.write(srv.encode_proof(proof))
    for k in ("q", "z_img", "seed"):
        w.write_scalar(b[k])
    w.write_list([x.to_bytes(32, "little") for x in b["pub_list"]])
    body = wire.verify_body(r1cs, proof.commitments, proof.t_c, b)
    assert body == w.getvalue()
    vreq = srv.parse_verify_request(body)
    assert (vreq.proof, vreq.score, vreq.z_img, vreq.seed, vreq.pub_list) == (
        proof, b["q"], b["z_img"], b["seed"], b["pub_list"])


@pytest.mark.parametrize("data", [b"\x80", b"\x05ab", b"\xff" * 10 + b"\x01"])
def test_the_reference_codec_refuses_a_broken_frame(data):
    with pytest.raises(wire.WireError):
        wire.frames(data)


def test_the_reference_envelope_refuses_a_short_point():
    with pytest.raises(wire.WireError):
        wire.parse_envelope(wire.envelope(b"\x00" * 33, [b"\x01" * 31], []))


# ---------------------------------------------------------------------------
# BatchingService: seeded arrivals, counters, spans, a short pass
# ---------------------------------------------------------------------------


def _dummy_proof(item, tag: int = 0) -> BlindBidProof:
    n = len(item.pub_list) if hasattr(item, "pub_list") else 4
    gen = np.random.default_rng(tag)
    return _random_proof(gen, n, t_x=DUMMY_TX)


@pytest.fixture
def passes(monkeypatch):
    """prove_batch / verify_batch replaced: they record their batch sizes; a
    prove answers a proof with t_x = DUMMY_TX, a verify accepts exactly those."""
    seen = []

    def prove(items, device=None, **_):
        seen.append(("prove", len(items)))
        return [_dummy_proof(item, i) for i, item in enumerate(items)]

    def verify(items, device=None, **_):
        seen.append(("verify", len(items)))
        return [getattr(item, "proof", None) is not None
                and item.proof.r1cs.t_x == DUMMY_TX for item in items]

    monkeypatch.setattr(blindbid, "prove_batch", prove)
    monkeypatch.setattr(blindbid, "verify_batch", verify)
    return seen


@pytest.fixture
def spans():
    profiling.reset()
    profiling.enable(True)
    try:
        yield profiling
    finally:
        profiling.enable(False)
        profiling.reset()


def _arrive(service, offsets_s: list[float]):
    """Submit one prove request at each offset (s) after the first; the
    results in submission order."""
    async def one(i, dt):
        await asyncio.sleep(dt)
        return await service.submit("prove", 4, f"req{i}")

    async def run():
        return await asyncio.gather(*(one(i, dt) for i, dt in enumerate(offsets_s)),
                                    return_exceptions=True)

    service.start()
    try:
        return asyncio.run(asyncio.wait_for(run(), timeout=120))
    finally:
        service.close()


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("n, sizes", [(3, [3]), (16, [16]), (23, [16, 7])])
def test_seeded_arrivals_inside_one_window_make_one_pass(passes, spans, seed, n, sizes):
    """n requests at seeded offsets inside the first fifth of a window: one
    pass, or one of `max_batch` and one of the rest; the counters add up."""
    window_ms = 400.0
    offsets = sorted(random.Random(seed).uniform(0.0, window_ms / 5e3) for _ in range(n))
    results = _arrive(srv.BatchingService(window_ms=window_ms, device="cpu"), offsets)
    assert [size for _, size in passes] == sizes
    assert all(isinstance(r, BlindBidProof) for r in results)
    counters = profiling.counters()
    assert counters["server.passes"] == len(sizes)
    assert counters["server.requests"] == n
    assert counters["server.queue_wait_s"] > 0.0
    assert [r.name for r in profiling.records()].count("server.pass") == len(sizes)


def test_the_counters_count_nothing_while_spans_are_off(passes):
    profiling.reset()
    profiling.enable(False)
    _arrive(srv.BatchingService(window_ms=50.0, device="cpu"), [0.0, 0.001])
    assert profiling.counters() == {} and profiling.records() == []
    profiling.count("server.passes")
    assert profiling.counters() == {}


def test_reset_clears_the_counters(spans):
    profiling.count("server.requests", 5)
    profiling.count("server.requests", 2)
    assert profiling.counters() == {"server.requests": 7}
    profiling.reset()
    assert profiling.counters() == {}


def test_a_short_pass_answers_every_waiter(monkeypatch, caplog):
    """A pass that returns fewer results than it was given requests: the
    requests it covers get their results, every other one the error frame,
    logged, and none is left waiting; the daemon serves on."""
    def short(items, device=None, **_):
        return [_dummy_proof(item, i) for i, item in enumerate(items)][:len(items) // 2]

    monkeypatch.setattr(blindbid, "prove_batch", short)
    results = _arrive(srv.BatchingService(window_ms=300.0, device="cpu"), [0.0] * 5)
    assert [isinstance(r, BlindBidProof) for r in results] == [True, True, False, False, False]
    assert all(isinstance(r, RuntimeError) and "2 results for 5 requests" in str(r)
               for r in results[2:])

    caplog.set_level(logging.ERROR, logger="blindbid.server")
    bidders = traffic.bidders(7, "short", 5, 4)
    frames = [wire.request(wire.OP_PROVE, wire.prove_body(b)) for b in bidders]

    def talk(path):
        out = [None] * 5
        go = threading.Barrier(5)

        def one(i):
            with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                s.settimeout(60)
                s.connect(path)
                go.wait(timeout=60)
                s.sendall(frames[i])
                out[i] = _recv_frame(s)

        threads = [threading.Thread(target=one, args=(i,)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        return out

    out, daemon = _serve(srv.BatchingService(window_ms=500.0, device="cpu"), talk)
    assert sorted(a == wire.ERROR for a in out) == [False, False, True, True, True]
    assert all(len(wire.parse_envelope(a)[2]) == 4 for a in out if a != wire.ERROR)
    assert daemon.fault is None
    assert sum("the pass returned 2 results for 5 requests" in r.getMessage()
               for r in caplog.records) == 3


def _recv_frame(s: socket.socket) -> bytes:
    head = data = b""
    while not head or head[-1] & 0x80:
        byte = s.recv(1)
        assert byte, "connection closed before a frame"
        head += byte
    n, _ = wire.read_varint(head, 0)
    while len(data) < n:
        chunk = s.recv(n - len(data))
        assert chunk, "connection closed mid-frame"
        data += chunk
    return data


def _serve(service, talk):
    """A live daemon on a fresh socket while `talk(path)` runs in a thread."""
    async def run(path):
        daemon = srv.BlindBidServer(path, service)
        await daemon.start()
        try:
            return await asyncio.to_thread(talk, path), daemon
        finally:
            await daemon.close()

    with tempfile.TemporaryDirectory() as tmp:
        return asyncio.run(asyncio.wait_for(run(os.path.join(tmp, "bb.sock")), timeout=300))


def test_the_event_loop_spans_and_the_counters_of_a_live_daemon(passes, spans):
    """Three sessions over the socket, each a prove then a verify: a
    `server.decode` and a `server.encode` span per request, on the loop's
    thread and outside any pass; the counters hold every pass."""
    bidders = traffic.bidders(11, "live", 3, 4)

    def talk(path):
        verdicts = []
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(60)
            s.connect(path)
            for b in bidders:
                s.sendall(wire.request(wire.OP_PROVE, wire.prove_body(b)))
                r1cs, comms, toggles = wire.parse_envelope(_recv_frame(s))
                s.sendall(wire.request(wire.OP_VERIFY, wire.verify_body(r1cs, comms, toggles, b)))
                verdicts.append(_recv_frame(s))
        return verdicts

    verdicts, _ = _serve(srv.BatchingService(device="cpu"), talk)
    assert verdicts == [wire.VALID] * 3
    recs = profiling.records()
    names = [r.name for r in recs]
    assert names.count("server.decode") == names.count("server.encode") == 6
    passes_thread = {r.thread for r in recs if r.name == "server.pass"}
    loop_spans = [r for r in recs if r.name in ("server.decode", "server.encode")]
    assert {r.thread for r in loop_spans}.isdisjoint(passes_thread)
    assert all(r.parent is None for r in loop_spans)
    counters = profiling.counters()
    assert counters["server.passes"] == len(passes) == 6
    assert counters["server.requests"] == 6


def _slow_passes(monkeypatch, seen, seconds):
    def prove(items, device=None, **_):
        seen.append(("prove", len(items), threading.current_thread().name))
        threading.Event().wait(seconds)
        return [_dummy_proof(item, i) for i, item in enumerate(items)]

    monkeypatch.setattr(blindbid, "prove_batch", prove)


def _three_full_passes_and_a_call(service, seen):
    """48 prove requests at once (three passes of `max_batch` queued on the
    worker), then one `run_on_worker` call once the first pass has begun;
    the call's thread and the results."""
    async def run():
        service.start()
        try:
            reqs = [asyncio.ensure_future(service.submit("prove", 4, f"req{i}"))
                    for i in range(48)]
            while not seen:
                await asyncio.sleep(0.001)
            thread = await service.run_on_worker(
                lambda: seen.append(("call", 0, threading.current_thread().name)) or "ran")
            return thread, await asyncio.gather(*reqs)
        finally:
            service.close()

    return asyncio.run(asyncio.wait_for(run(), timeout=120))


def test_a_call_on_the_worker_runs_there_ahead_of_the_queued_passes(monkeypatch):
    """`run_on_worker` runs its call on the worker thread, after the pass that
    is running and before the two queued behind it, and returns its value;
    on an idle worker it runs at once."""
    seen = []
    _slow_passes(monkeypatch, seen, 0.3)
    ran, results = _three_full_passes_and_a_call(srv.BatchingService(device="cpu"), seen)
    assert ran == "ran" and len(results) == 48
    assert [(kind, n) for kind, n, _ in seen] == [("prove", 16), ("call", 0),
                                                   ("prove", 16), ("prove", 16)]
    assert len({thread for _, _, thread in seen}) == 1
    assert seen[0][2].startswith("blindbid-device")

    async def idle():
        service = srv.BatchingService(device="cpu")
        service.start()
        try:
            return await service.run_on_worker(threading.current_thread)
        finally:
            service.close()

    assert asyncio.run(idle()).name.startswith("blindbid-device")


def test_the_driver_reaches_a_worker_without_run_on_worker_the_same_way(monkeypatch):
    """A port whose service lacks `run_on_worker` and the counters: the
    driver's wrapper around its pass runs the call between the same passes
    and counts the passes and requests while the tracer is on."""
    class Before(srv.BatchingService):
        def __getattribute__(self, name):
            if name == "run_on_worker":
                raise AttributeError(name)
            return super().__getattribute__(name)

    seen = []
    _slow_passes(monkeypatch, seen, 0.3)
    service = Before(device="cpu")
    assert not hasattr(service, "run_on_worker")
    tracer = SimpleNamespace(active=False)

    async def run():
        service.start()
        try:
            run_on_worker, counts = uds_closed._worker(service, tracer)
            reqs = [asyncio.ensure_future(service.submit("prove", 4, f"req{i}"))
                    for i in range(48)]
            while not seen:
                await asyncio.sleep(0.001)
            await run_on_worker(lambda: seen.append(("call", 0, threading.current_thread().name))
                                or setattr(tracer, "active", True))
            await asyncio.gather(*reqs)
            return counts()
        finally:
            service.close()

    counts = asyncio.run(asyncio.wait_for(run(), timeout=120))
    assert [(kind, n) for kind, n, _ in seen] == [("prove", 16), ("call", 0),
                                                   ("prove", 16), ("prove", 16)]
    assert len({thread for _, _, thread in seen}) == 1
    assert counts == (2, 32, None)


# ---------------------------------------------------------------------------
# The readers
# ---------------------------------------------------------------------------


def test_the_server_readers_on_a_synthetic_record():
    fill, host = _reader("server.fill.batch"), _reader("server.host_ms.batch")
    record = {"proofs": 4.0, "span_total_s": {"server.decode": 0.010, "server.encode": 0.002,
                                              "server.pass": 9.0},
              "program_counters": {"server.passes": 8.0, "server.requests": 11.0}}
    assert fill.read(record) == pytest.approx(11.0 / 8.0)
    assert host.read(record) == pytest.approx(3.0)
    assert host.read(dict(record, span_total_s={"server.encode": 0.004})) == pytest.approx(1.0)


@pytest.mark.parametrize("record", [
    {},
    {"proofs": 0, "span_total_s": {"server.decode": 1.0},
     "program_counters": {"server.passes": 0.0, "server.requests": 0.0}},
    {"proofs": 4, "span_total_s": {"prove": 1.0}, "program_counters": {"server.requests": 3.0}},
    {"proofs": 4, "span_total_s": {}, "program_counters": None},
], ids=["empty", "nothing-passed", "other-spans", "no-counters"])
def test_the_server_readers_read_nothing_where_the_record_lacks_their_inputs(record):
    assert _reader("server.fill.batch").read(record) is None
    assert _reader("server.host_ms.batch").read(record) is None


# ---------------------------------------------------------------------------
# The client process against a stub daemon
# ---------------------------------------------------------------------------


class StubDaemon:
    """Wire bytes only: a prove answers an envelope (t_x = DUMMY_TX) or, for
    the statements of `refuse` (by their seed scalar), the error frame; a
    verify answers 0x01 for the envelope's own bytes and 0x00 otherwise."""

    def __init__(self, refuse: set[int]):
        self.refuse = refuse
        self.r1cs = _random_r1cs(np.random.default_rng(5), 11, t_x=DUMMY_TX).to_bytes()

    async def handle(self, reader, writer):
        try:
            while True:
                head = b""
                while not head or head[-1] & 0x80:
                    head += await reader.readexactly(1)
                n, _ = wire.read_varint(head, 0)
                req = await reader.readexactly(n)
                body = wire.frames(req[1:])
                if req[0] == wire.OP_PROVE:
                    seed = int.from_bytes(body[6], "little")
                    toggles = wire.frames(body[7])
                    answer = wire.ERROR if seed in self.refuse else wire.envelope(
                        self.r1cs, [bytes(32)] * 4, [bytes(32)] * len(toggles))
                else:
                    r1cs = wire.parse_envelope(body[0])[0]
                    answer = wire.VALID if r1cs == self.r1cs else wire.INVALID
                writer.write(wire.frame(answer))
                await writer.drain()
        except asyncio.IncompleteReadError:
            pass
        finally:
            writer.close()


def _client(tmp: Path, path: str, seed: int, tr: dict, seconds: float) -> list[dict]:
    params = dict(socket=path, seed=seed, list_len=4, seconds=seconds,
                  out=str(tmp / "sessions.json"), traffic=tr, answer_timeout_s=30.0)
    (tmp / "client.json").write_text(json.dumps(params))
    with subprocess.Popen([sys.executable, str(uds_closed.CLIENT), str(tmp / "client.json")],
                          stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True) as proc:
        try:
            ready = json.loads(proc.stdout.readline())
            assert ready["ready"] > 0
            proc.stdin.write("go\n")
            proc.stdin.flush()
            done = json.loads(proc.stdout.readline())
            assert proc.wait(timeout=120) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
    sessions = json.loads((tmp / "sessions.json").read_text())
    assert len(sessions) == done["done"]
    return sessions


def test_the_client_reads_honest_altered_and_refused_sessions():
    """Honest sessions read 0x01, altered ones 0x00, and an error frame
    leaves the session missing, as the judge counts it."""
    seed = 3000000021
    tr = dict(connections=3, stagger_s=0.05, think_ms_mean=5, distinct_sessions=4,
              altered_every=3, sample=0, regenerate=0, trace_passes=1)
    statements = traffic.bidders(seed, "sessions", 4, 4)
    stub = StubDaemon(refuse={statements[1]["seed"]})
    tmp = Path(tempfile.mkdtemp(prefix="uds."))
    path = str(tmp / "bb.sock")

    async def serve():
        server = await asyncio.start_unix_server(stub.handle, path=path)
        async with server:
            return await asyncio.to_thread(_client, tmp, path, seed, tr, 0.5)

    try:
        sessions = asyncio.run(asyncio.wait_for(serve(), timeout=300))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert len(sessions) >= 12
    assert [s["index"] for s in sessions] == list(range(len(sessions)))
    assert [s["statement"] for s in sessions] == [i % 4 for i in range(len(sessions))]
    blocks = [sessions[i:i + 3] for i in range(0, len(sessions) - 2, 3)]
    assert all(sum(s["tampered"] for s in block) == 1 for block in blocks)
    for s in sessions:
        if s["statement"] == 1:
            assert s["r1cs"] is None and s["verdict"] is None
        else:
            assert s["verdict"] is (not s["tampered"])
            assert len(s["commitments"]) == 4 and len(s["toggles"]) == 4
        assert s["end"] >= s["start"]
    assert any(s["tampered"] and s["verdict"] is False for s in sessions)
    assert any(not s["tampered"] and s["verdict"] is True for s in sessions)

    # what the driver hands the judge: each refused session is missing
    ctx = SimpleNamespace(seed=seed, cell={"traffic": tr}, config={"list_len": 4})
    answers = uds_closed._answers(ctx, sessions)
    checks = harness.Checks()
    harness.judge(checks, 2048, answers, [], traffic.rng(seed, "judge"), 0)
    counts = {name: value for name, value, _ in checks.rows}
    assert counts["missing"] == sum(s["statement"] == 1 for s in sessions)
    assert counts["verdict_wrong"] == 0 and counts["ref_disagree"] == 0


def test_the_client_imports_nothing_of_the_port():
    code = ("import sys; import bench_cuda.uds_client; bad = sorted(m for m in sys.modules"
            " if m.split('.')[0] in ('torch', 'dusk_blindbidproof_tpu_torch', 'jax',"
            " 'dusk_blindbidproof_tpu')); print(bad)")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# The driver against the port's daemon, device passes replaced, traced
# ---------------------------------------------------------------------------


@pytest.fixture
def restored(monkeypatch):
    """Everything `Tracer.install` wraps, put back after the test."""
    for obj, name in [(bulletproofs, "span"), (bulletproofs.Prover, "prove"),
                      (bulletproofs.Verifier, "verify"), (blindbid, "prove_batch"),
                      (blindbid, "verify_batch")] + [(fused, n) for n in
                                                     tracing.roofline.WRAPPERS]:
        monkeypatch.setattr(obj, name, getattr(obj, name))


def test_the_driver_serves_every_session_and_traces_passes_of_the_second_half(restored, passes):
    tr = dict(CELL["traffic"], connections=6, stagger_s=0.05, think_ms_mean=5,
              distinct_sessions=8, altered_every=4, trace_passes=4)
    run_dir = Path(tempfile.mkdtemp(prefix="uds."))
    ctx = SimpleNamespace(name="uds-tiny", cell=dict(CELL, traffic=tr), config=CONFIG,
                          seed=3000000023, seconds=6.0, trace=True,
                          device=torch.device("cpu"), fault=None, t0=0.0, root=ROOT,
                          run_dir=run_dir, log=lambda msg: None)
    try:
        out = uds_closed.run(ctx)
        record = tracing.summarize(out["trace_path"], out["counters"])
    finally:
        profiling.reset()
        shutil.rmtree(run_dir, ignore_errors=True)
    answers = out["answers"]
    assert out["attempted"] == len(answers) >= 8 and out["failed"] == 0
    assert all(a["verdict"] is (not a["tampered"]) for a in answers)
    full_blocks = [answers[i:i + 4] for i in range(0, len(answers) - 3, 4)]
    assert all(sum(a["tampered"] for a in block) == 1 for block in full_blocks)
    assert out["metrics"]["proofs_per_s"] > 0 and out["metrics"]["setup_s"] > 0
    tampered = [i for i, a in enumerate(answers) if a["tampered"]]
    assert set(tampered) & set(out["picks"])

    # the stop comes at a pass boundary once the 4th pass began; the window is
    # long enough for that beyond the CPU profiler's start (about 2 s)
    c = out["counters"]
    assert c["traced_passes"] >= 4
    assert c["program_counters"]["server.passes"] == c["traced_passes"]
    assert c["program_counters"]["server.requests"] == c["traced_requests"]
    assert out["traced_proofs"] == c["traced_requests"] / 2
    record["proofs"] = out["traced_proofs"]
    fill = _reader("server.fill.batch").read(record)
    assert fill == c["traced_requests"] / c["traced_passes"] and fill >= 1.0
    assert _reader("server.host_ms.batch").read(record) > 0
    assert _reader("app.host_ms.batch").read(record) is None  # the passes were replaced
