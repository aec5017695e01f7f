"""The port's server layer on the CPU, with no prover in the loop: TLV codec,
proof wire format, request parsing, dispatch, batching, start-up, and a live
daemon on a Unix socket with stubbed device passes.

Every case of tests/test_server.py runs against the port; for inputs made
from a seed with numpy the port's codec and parsers give the JAX package's
bytes and fields (exact: bytes and integers, no tolerance); the recorded
sessions of tests/data replay through the port.  The two `slow` cases at the
end run the whole slice at n = 2048 on the CPU against the recorded bytes.
"""

import asyncio
import importlib.util
import io
import logging
import os
import re
import socket
import tempfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu import server as jsrv
from dusk_blindbidproof_tpu.models import proof_struct as jps
from dusk_blindbidproof_tpu.utils import tlv as jtlv
from dusk_blindbidproof_tpu_torch import server as srv
from dusk_blindbidproof_tpu_torch.errors import TlvError, UnexpectedEof
from dusk_blindbidproof_tpu_torch.models import blindbid, bulletproofs
from dusk_blindbidproof_tpu_torch.models.bid import Bid, scalar_from_bits
from dusk_blindbidproof_tpu_torch.models.proof_struct import BlindBidProof, R1CSProof
from dusk_blindbidproof_tpu_torch.models.transcript_protocol import (
    IDENTITY_COMPRESSED,
    ProofError,
)
from dusk_blindbidproof_tpu_torch.ops import fused, limb
from dusk_blindbidproof_tpu_torch.utils import curve_host, profiling
from dusk_blindbidproof_tpu_torch.utils.curve_host import L
from dusk_blindbidproof_tpu_torch.utils.tlv import (
    TlvReader,
    TlvWriter,
    read_varint,
    write_varint,
)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
SEEDS = [0, 1, 2, 3]


def _client():
    spec = importlib.util.spec_from_file_location(
        "uds_client_torch", ROOT / "scripts" / "uds_client_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


client = _client()


# ---------------------------------------------------------------------------
# TLV codec
# ---------------------------------------------------------------------------

VARINTS = [0, 1, 127, 128, 300, 2**14, 2**21 - 1, 2**32, 2**63 - 1]


@pytest.mark.parametrize("n", VARINTS)
def test_varint_round_trip(n):
    assert read_varint(io.BytesIO(write_varint(n))) == n
    assert write_varint(n) == jtlv.write_varint(n)


def test_varint_rejects_overlong():
    with pytest.raises(TlvError):
        read_varint(io.BytesIO(b"\x80" * 10 + b"\x01"))


def test_varint_truncation():
    assert read_varint(io.BytesIO(b"")) is None  # clean EOF between frames
    with pytest.raises(UnexpectedEof):
        read_varint(io.BytesIO(b"\x80"))  # EOF mid-varint


def test_frame_round_trip():
    w = TlvWriter()
    w.write(b"hello")
    w.write(b"")
    w.write(b"x" * 300)
    r = TlvReader(w.getvalue())
    assert r.read_frame() == b"hello"
    assert r.read_frame() == b""
    assert r.read_frame() == b"x" * 300
    assert r.read_frame() is None


def test_list_round_trip():
    items = [b"a", b"bb", b"", b"c" * 200]
    w = TlvWriter()
    w.write_list(items)
    assert TlvReader(w.getvalue()).read_list() == items


def test_truncated_frame_raises():
    w = TlvWriter()
    w.write(b"hello")
    with pytest.raises(EOFError):
        TlvReader(w.getvalue()[:-1]).read_frame()


@pytest.mark.parametrize("read, size", [("read_scalar_bytes", 31), ("read_u64", 9)])
def test_fixed_frame_length_check(read, size):
    w = TlvWriter()
    w.write(b"\x01" * size)
    with pytest.raises(ValueError):
        getattr(TlvReader(w.getvalue()), read)()


@pytest.mark.parametrize("seed", SEEDS)
def test_writer_bytes_equal_the_jax_package(seed):
    """One seeded stream of frames, lists, scalars and u64s through both
    writers: equal bytes; the port's reader gets every value back."""
    rng = np.random.default_rng(seed)
    frames = [rng.bytes(int(n)) for n in rng.integers(0, 400, size=6)]
    items = [rng.bytes(int(n)) for n in rng.integers(0, 200, size=5)]
    scalars = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(4)]
    u64s = [int(x) for x in rng.integers(0, 2**63, size=3)]
    out = []
    for writer in (TlvWriter(), jtlv.TlvWriter()):
        for f in frames:
            writer.write(f)
        writer.write_list(items)
        for s in scalars:
            writer.write_scalar(s)
        for x in u64s:
            writer.write_u64(x)
        out.append(writer.getvalue())
    assert out[0] == out[1]
    r = TlvReader(out[0])
    assert [r.read_frame() for _ in frames] == frames
    assert r.read_list() == items
    assert [int.from_bytes(r.read_scalar_bytes(), "little") for _ in scalars] == scalars
    assert [r.read_u64() for _ in u64s] == u64s
    assert r.read_frame() is None


# ---------------------------------------------------------------------------
# Proof wire format
# ---------------------------------------------------------------------------


def _dummy_r1cs(rounds=11, phase2=False, cls=R1CSProof, tag=0):
    p = lambda i: bytes([i, tag]) + bytes(30)  # noqa: E731
    return cls(
        A_I1=p(1), A_O1=p(2), S1=p(3),
        A_I2=p(4) if phase2 else IDENTITY_COMPRESSED,
        A_O2=p(5) if phase2 else IDENTITY_COMPRESSED,
        S2=p(6) if phase2 else IDENTITY_COMPRESSED,
        T_1=p(7), T_3=p(8), T_4=p(9), T_5=p(10), T_6=p(11),
        t_x=123, t_x_blinding=456, e_blinding=789 + tag,
        ipp_L=[p(20 + i) for i in range(rounds)],
        ipp_R=[p(40 + i) for i in range(rounds)],
        ipp_a=111, ipp_b=222,
    )


def _dummy_proof(n_toggles=4, tag=0):
    return BlindBidProof(
        r1cs=_dummy_r1cs(tag=tag), commitments=[bytes([i]) * 32 for i in range(4)],
        t_c=[bytes([10 + i]) * 32 for i in range(n_toggles)],
    )


@pytest.mark.parametrize("phase2", [False, True])
def test_r1cs_proof_round_trip(phase2):
    proof = _dummy_r1cs(phase2=phase2)
    data = proof.to_bytes()
    assert data[0] == int(phase2)
    assert R1CSProof.from_bytes(data) == proof
    assert data == _dummy_r1cs(phase2=phase2, cls=jps.R1CSProof).to_bytes()


def _with_scalar_l():
    data = bytearray(_dummy_r1cs().to_bytes())
    data[1 + 32 * 8 : 1 + 32 * 9] = L.to_bytes(32, "little")
    return bytes(data)


@pytest.mark.parametrize("data", [
    b"", bytes([9]) + bytes(32 * 20), bytes([0]) + bytes(33), _with_scalar_l(),
], ids=["empty", "bad-version", "not-32-aligned", "scalar-equals-l"])
def test_r1cs_proof_rejects_garbage(data):
    with pytest.raises(ProofError):
        R1CSProof.from_bytes(data)


def test_blindbid_proof_envelope_round_trip():
    proof = _dummy_proof(n_toggles=5)
    assert srv.decode_proof(srv.encode_proof(proof)) == proof


def _random_proof(rng, cls_r1cs, cls_proof, rounds, n_toggles=4):
    pt = lambda: rng.bytes(32)  # noqa: E731
    sc = lambda: int.from_bytes(rng.bytes(32), "little") % L  # noqa: E731
    fields = dict(
        A_I1=pt(), A_O1=pt(), S1=pt(), A_I2=IDENTITY_COMPRESSED, A_O2=IDENTITY_COMPRESSED,
        S2=IDENTITY_COMPRESSED, T_1=pt(), T_3=pt(), T_4=pt(), T_5=pt(), T_6=pt(),
        t_x=sc(), t_x_blinding=sc(), e_blinding=sc(),
        ipp_L=[pt() for _ in range(rounds)], ipp_R=[pt() for _ in range(rounds)],
        ipp_a=sc(), ipp_b=sc(),
    )
    head = [pt() for _ in range(4 + n_toggles)]
    return cls_proof(r1cs=cls_r1cs(**fields), commitments=head[:4], t_c=head[4:])


@pytest.mark.parametrize("seed", SEEDS)
def test_encode_proof_bytes_equal_the_jax_package(seed):
    rounds = 5 + seed
    ours = _random_proof(np.random.default_rng(seed), R1CSProof, BlindBidProof, rounds)
    theirs = _random_proof(np.random.default_rng(seed), jps.R1CSProof, jps.BlindBidProof, rounds)
    data = srv.encode_proof(ours)
    assert data == jsrv.encode_proof(theirs)
    back, jback = srv.decode_proof(data), jsrv.decode_proof(data)
    assert back == ours
    assert (back.commitments, back.t_c) == (jback.commitments, jback.t_c)
    assert back.r1cs.to_bytes() == jback.r1cs.to_bytes()


# ---------------------------------------------------------------------------
# Request parsing (opcode bodies)
# ---------------------------------------------------------------------------


def _prove_body(d=5, k=6, y=7, y_inv=8, q=9, z_img=10, seed=11,
                pub_list=(1, 2, 3), toggle=1, entry_len=32):
    w = TlvWriter()
    for v in (d, k, y, y_inv, q, z_img, seed):
        w.write(v.to_bytes(32, "little"))
    w.write_list([v.to_bytes(entry_len, "little") for v in pub_list])
    w.write(toggle.to_bytes(8, "little"))
    return w.getvalue()


def _verify_body(proof, scalars=(100, 200, 300), pub_list=(1, 2, 3)):
    w = TlvWriter()
    w.write(srv.encode_proof(proof))
    for v in scalars:
        w.write(v.to_bytes(32, "little"))
    w.write_list([v.to_bytes(32, "little") for v in pub_list])
    return w.getvalue()


def test_parse_prove_request():
    req = srv.parse_prove_request(_prove_body())
    assert (req.d, req.k, req.y, req.y_inv) == (5, 6, 7, 8)
    assert (req.q, req.z_img, req.seed) == (9, 10, 11)
    assert req.pub_list == [1, 2, 3]
    assert req.toggle == 1


@pytest.mark.parametrize("name", ["d", "k", "y", "y_inv", "q", "z_img", "seed"])
def test_parse_prove_rejects_non_canonical_scalar(name):
    with pytest.raises(TlvError, match=name):
        srv.parse_prove_request(_prove_body(**{name: L}))


@pytest.mark.parametrize("entry_len", [31, 33])
def test_parse_prove_rejects_bad_entry_length(entry_len):
    # only 32-byte entries decode
    with pytest.raises(ValueError):
        srv.parse_prove_request(_prove_body(entry_len=entry_len))


def test_parse_prove_pub_list_from_bits():
    """255-bit entries at or above l pass through unreduced (from_bits)."""
    big = (1 << 255) - 1
    req = srv.parse_prove_request(_prove_body(pub_list=(big,)))
    assert req.pub_list == [big]


@pytest.mark.parametrize("value", [L, L + 5, (1 << 255) - 1, (1 << 255) + L, (1 << 256) - 1],
                         ids=["l", "l+5", "2^255-1", "2^255+l", "2^256-1"])
def test_bid_from_bits_masks_and_does_not_reduce(value):
    """Bit 255 is masked, nothing is reduced mod l on the wire; the limbs
    the prover and verifier compute with are the value mod l."""
    raw = value.to_bytes(32, "little")
    want = value & ((1 << 255) - 1)
    assert want >= L
    assert scalar_from_bits(raw) == Bid.from_bytes(raw).x == want
    assert Bid.from_bytes(raw).to_bytes() == want.to_bytes(32, "little")
    w = TlvWriter()
    w.write_list([raw])
    assert [b.x for b in Bid.try_list_from_reader(TlvReader(w.getvalue()))] == [want]
    limbs = blindbid._publics_limbs([[want]])
    assert limb.limbs_to_int(limbs[0, 0]) == want % L


def test_parse_verify_request():
    proof = _dummy_proof(n_toggles=3)
    req = srv.parse_verify_request(_verify_body(proof))
    assert (req.score, req.z_img, req.seed) == (100, 200, 300)
    assert req.pub_list == [1, 2, 3]
    assert req.proof == proof


@pytest.mark.parametrize("index, name", [(0, "score"), (1, "z_img"), (2, "seed")])
def test_parse_verify_rejects_non_canonical_scalar(index, name):
    scalars = [100, 200, 300]
    scalars[index] = L
    with pytest.raises(TlvError, match=name):
        srv.parse_verify_request(_verify_body(_dummy_proof(), scalars=scalars))


def _seeded_prove_fields(seed, list_len=None):
    """Seven canonical scalars, a bid list (2 + seed entries unless
    `list_len` is given) and a toggle place inside it."""
    rng = np.random.default_rng(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(7)]
    n = 2 + seed if list_len is None else list_len
    # entries over the whole 256-bit range: bit 255 set and values >= l occur
    pub_list = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    return scalars, pub_list, int(rng.integers(0, n))


# (seed, list length): 2 + seed entries, then the usual list of 4 and the
# longest list the generators hold (202 bids: n1 = 1442 + 3 x 202 = 2048)
PARSE_CASES = ([pytest.param(s, None, id=str(s)) for s in SEEDS]
               + [pytest.param(s, n, id=f"{s}-L{n}") for n in (4, 202) for s in SEEDS])


@pytest.mark.parametrize("seed, list_len", PARSE_CASES)
def test_parse_prove_equals_the_jax_package(seed, list_len):
    scalars, pub_list, toggle = _seeded_prove_fields(seed, list_len)
    body = _prove_body(*scalars, pub_list=pub_list, toggle=toggle)
    ours, theirs = srv.parse_prove_request(body), jsrv.parse_prove_request(body)
    assert vars(ours) == vars(theirs)
    assert [ours.d, ours.k, ours.y, ours.y_inv, ours.q, ours.z_img, ours.seed] == scalars
    assert ours.pub_list == [v & ((1 << 255) - 1) for v in pub_list]
    assert len(ours.pub_list) == len(pub_list)


@pytest.mark.parametrize("seed, list_len", PARSE_CASES)
def test_parse_verify_equals_the_jax_package(seed, list_len):
    rng = np.random.default_rng(100 + seed)
    proof = _random_proof(rng, R1CSProof, BlindBidProof, 11,
                          n_toggles=4 if list_len is None else list_len)
    scalars, pub_list, _ = _seeded_prove_fields(seed, list_len)
    body = _verify_body(proof, scalars=scalars[:3], pub_list=pub_list)
    ours, theirs = srv.parse_verify_request(body), jsrv.parse_verify_request(body)
    assert (ours.score, ours.z_img, ours.seed) == (theirs.score, theirs.z_img, theirs.seed)
    assert ours.pub_list == theirs.pub_list
    assert srv.encode_proof(ours.proof) == jsrv.encode_proof(theirs.proof)
    assert len(ours.proof.t_c) == len(proof.t_c)


# ---------------------------------------------------------------------------
# Recorded sessions (tests/data/session_*.bin, made by the JAX package)
# ---------------------------------------------------------------------------


def _load(name):
    r = TlvReader((DATA / name).read_bytes())
    request = r.expect_frame("request")
    response = r.expect_frame("response")
    assert r.read_frame() is None
    return request, response


def test_prove_session_replay():
    request, response = _load("session_prove.bin")
    assert request[0] == srv.OP_PROVE
    req = srv.parse_prove_request(request[1:])
    w = TlvWriter()
    for v in (req.d, req.k, req.y, req.y_inv, req.q, req.z_img, req.seed):
        w.write_scalar(v)
    w.write_list([x.to_bytes(32, "little") for x in req.pub_list])
    w.write_u64(req.toggle)
    assert bytes([srv.OP_PROVE]) + w.getvalue() == request

    r = TlvReader(response)
    proof_frame = r.expect_frame("proof")
    assert r.read_frame() is None
    proof = srv.decode_proof(proof_frame)
    assert srv.encode_proof(proof) == proof_frame
    w = TlvWriter()
    w.write(srv.encode_proof(proof))
    assert w.getvalue() == response


def test_verify_session_replay():
    request, response = _load("session_verify.bin")
    assert request[0] == srv.OP_VERIFY
    vreq = srv.parse_verify_request(request[1:])
    w = TlvWriter()
    w.write(srv.encode_proof(vreq.proof))
    for v in (vreq.score, vreq.z_img, vreq.seed):
        w.write_scalar(v)
    w.write_list([x.to_bytes(32, "little") for x in vreq.pub_list])
    assert bytes([srv.OP_VERIFY]) + w.getvalue() == request
    assert TlvReader(response).expect_frame("status") == b"\x01"


def test_sessions_cross_consistent():
    """The proof inside the verify request is the prove response's proof."""
    _, prove_resp = _load("session_prove.bin")
    verify_req, _ = _load("session_verify.bin")
    proof_frame = TlvReader(prove_resp).expect_frame("proof")
    assert TlvReader(verify_req[1:]).expect_frame("proof") == proof_frame


def test_client_script_builds_the_recorded_request():
    """scripts/uds_client_torch.py derives the publics and encodes the bodies
    exactly as the recorded session's maker did."""
    prove_req, prove_resp = _load("session_prove.bin")
    verify_req, _ = _load("session_verify.bin")
    body, pub = client.build_prove_body(d=123456789, k=987654321, seed=42424242,
                                        extra=[1111, 2222, 3333], pos=1)
    assert bytes([client.OP_PROVE]) + body == prove_req
    proof_frame = TlvReader(prove_resp).expect_frame("proof")
    assert bytes([client.OP_VERIFY]) + client.build_verify_body(proof_frame, pub) == verify_req


# ---------------------------------------------------------------------------
# Dispatch (stubbed service: no device work)
# ---------------------------------------------------------------------------


class _StubService:
    def __init__(self, result):
        self.result = result
        self.calls = []

    async def submit(self, kind, shape_key, item):
        self.calls.append((kind, shape_key, item))
        if isinstance(self.result, Exception):
            raise self.result
        return self.result


def _dispatch(service, request: bytes):
    s = srv.BlindBidServer("/tmp/unused.sock", service=service)
    return TlvReader(asyncio.run(s._dispatch(request))).read_frame(), s


def test_dispatch_unknown_opcode_answers_error_frame():
    service = _StubService(None)
    frame, server = _dispatch(service, b"\x09whatever")
    assert frame == srv.ERROR_FRAME
    assert service.calls == [] and server.fault is None


def test_dispatch_empty_request_answers_error_frame():
    assert _dispatch(_StubService(None), b"")[0] == srv.ERROR_FRAME


def test_dispatch_malformed_prove_answers_error_frame():
    assert _dispatch(_StubService(None), b"\x01\x05hello")[0] == srv.ERROR_FRAME


@pytest.mark.parametrize("ok, frame", [(False, b"\x00"), (True, b"\x01")])
def test_dispatch_verify_verdict_is_normal_response(ok, frame):
    """A failed verification is payload 0x00, NOT the error frame."""
    body = _verify_body(_dummy_proof(n_toggles=2), scalars=(1, 2, 3), pub_list=(1, 2))
    service = _StubService(ok)
    assert _dispatch(service, b"\x02" + body)[0] == frame
    assert [(c[0], c[1]) for c in service.calls] == [("verify", (2, 11))]


def test_dispatch_prove_key_and_response():
    proof = _dummy_proof()
    service = _StubService(proof)
    frame, _ = _dispatch(service, b"\x01" + _prove_body(pub_list=(1, 2, 3, 4)))
    assert srv.decode_proof(frame) == proof
    assert [(c[0], c[1]) for c in service.calls] == [("prove", 4)]


@pytest.mark.parametrize("exc, is_fault", [
    (ValueError("toggle out of range"), False),
    (ProofError("non-canonical point encoding"), False),
    pytest.param(ProofError("circuit exceeds generator capacity: n_pad 4096 > cap 2048"),
                 False, id="ProofError-capacity"),
    (TlvError("bad"), False),
    (AssertionError("circuit exceeds generator capacity"), False),
    (RuntimeError("zeros: Dimension size must be non-negative."), False),
    (NotImplementedError("no kernel for this dtype"), False),
    (RecursionError("maximum recursion depth exceeded"), False),
    (fused.KernelError("kernel add failed to launch: cudaError 700"), True),
    pytest.param(fused.KernelError("nvcc failed (1)"), True, id="KernelError-build"),
    (torch.AcceleratorError("CUDA error: an illegal memory access was encountered"), True),
    (torch.OutOfMemoryError("CUDA out of memory"), True),
], ids=lambda v: type(v).__name__ if isinstance(v, Exception) else None)
def test_dispatch_service_exception_contained(exc, is_fault):
    """Every failure answers the error frame; only the device's own faults
    (KernelError, AcceleratorError, OutOfMemoryError) are also kept and stop
    the server.  A torch shape check's RuntimeError is not one of them."""
    body = _verify_body(_dummy_proof(n_toggles=2), scalars=(1, 2, 3), pub_list=(1, 2))
    frame, server = _dispatch(_StubService(exc), b"\x02" + body)
    assert frame == srv.ERROR_FRAME
    assert (server.fault is exc) == is_fault
    assert server._stop.is_set() == is_fault


# ---------------------------------------------------------------------------
# BatchingService (the passes replaced by recorders)
# ---------------------------------------------------------------------------


@pytest.fixture
def passes(monkeypatch):
    """prove_batch / verify_batch replaced: they record (kind, items, device,
    thread) and answer one result an item."""
    seen = []

    def fake(kind):
        def run(items, device=None):
            seen.append((kind, list(items), device, threading.current_thread().name))
            for item in items:
                if isinstance(item, Exception):
                    raise item
            if kind == "verify":
                return [True] * len(items)
            return [_dummy_proof(tag=i) for i in range(len(items))]
        return run

    monkeypatch.setattr(blindbid, "prove_batch", fake("prove"))
    monkeypatch.setattr(blindbid, "verify_batch", fake("verify"))
    return seen


def _submit_all(service, submissions):
    async def run():
        return await asyncio.gather(
            *(service.submit(kind, key, item) for kind, key, item in submissions),
            return_exceptions=True)

    service.start()
    try:
        return asyncio.run(asyncio.wait_for(run(), timeout=60))
    finally:
        service.close()


@pytest.mark.parametrize("n, sizes", [(1, [1]), (5, [5]), (11, [11]), (16, [16]),
                                      (17, [16, 1]), (35, [16, 16, 3])])
def test_batching_flushes_what_arrived(passes, n, sizes):
    """n submits inside one window: one pass, or passes of `max_batch` and
    the rest; every waiter gets the result at its own place."""
    service = srv.BatchingService(device="cpu")
    results = _submit_all(service, [("prove", 4, f"req{i}") for i in range(n)])
    assert [len(items) for _, items, _, _ in passes] == sizes
    assert [item for _, items, _, _ in passes for item in items] == [f"req{i}" for i in range(n)]
    want = [_dummy_proof(tag=i) for size in sizes for i in range(size)]
    assert results == want
    assert {dev for _, _, dev, _ in passes} == {torch.device("cpu")}
    assert len({name for _, _, _, name in passes}) == 1  # one worker thread


def test_batching_keys_keep_shapes_apart(passes):
    service = srv.BatchingService(device="cpu")
    subs = [("prove", 4, "a"), ("prove", 5, "b"), ("verify", (4, 11), "c"),
            ("prove", 4, "d"), ("verify", (4, 10), "e"), ("verify", (4, 11), "f")]
    results = _submit_all(service, subs)
    assert sorted((kind, items) for kind, items, _, _ in passes) == [
        ("prove", ["a", "d"]), ("prove", ["b"]), ("verify", ["c", "f"]), ("verify", ["e"])]
    assert results[2] is True and results[0] == _dummy_proof(tag=0)
    assert results[3] == _dummy_proof(tag=1)


def test_batching_keeps_list_lengths_apart(passes):
    """202-bid and 4-bid requests that arrive together, parsed and submitted
    by `_dispatch` as the daemon does: each list length flushes as a batch of
    its own under its own key, and every answer goes to its own request."""
    service = srv.BatchingService(window_ms=200.0, device="cpu")
    server = srv.BlindBidServer("/tmp/unused.sock", service=service)
    keys = []
    submit = service.submit

    async def recording_submit(kind, shape_key, item):
        keys.append((kind, shape_key))
        return await submit(kind, shape_key, item)

    service.submit = recording_submit
    lists = {202: [1000 + i for i in range(202)], 4: [1, 2, 3, 4]}
    order = [202, 4, 202, 4, 202]
    requests = [b"\x01" + _prove_body(seed=11 + i, pub_list=lists[n], toggle=i % n)
                for i, n in enumerate(order)]
    requests += [b"\x02" + _verify_body(_dummy_proof(n_toggles=n), pub_list=lists[n])
                 for n in order]

    async def run():
        return await asyncio.gather(*(server._dispatch(r) for r in requests))

    service.start()
    try:
        answers = asyncio.run(asyncio.wait_for(run(), timeout=60))
    finally:
        service.close()
    assert keys == [("prove", n) for n in order] + [("verify", (n, 11)) for n in order]
    batches = sorted((kind, len(items[0].pub_list), [r.seed for r in items])
                     for kind, items, _, _ in passes)
    assert batches == [("prove", 4, [12, 14]), ("prove", 202, [11, 13, 15]),
                       ("verify", 4, [300, 300]), ("verify", 202, [300, 300, 300])]
    frames = [TlvReader(a).read_frame() for a in answers]
    # a prove answer is the stub's proof for its place in its own batch
    place = {11: 0, 13: 1, 15: 2, 12: 0, 14: 1}
    assert [srv.decode_proof(f) for f in frames[:5]] == [
        _dummy_proof(tag=place[11 + i]) for i in range(5)]
    assert frames[5:] == [b"\x01"] * 5
    assert server.fault is None


def test_batching_exception_reaches_every_waiter(passes):
    service = srv.BatchingService(device="cpu")
    boom = ValueError("toggle out of range")
    results = _submit_all(service, [("prove", 4, "a"), ("prove", 4, boom), ("prove", 4, "c"),
                                    ("verify", (4, 11), "v")])
    assert results[:3] == [boom, boom, boom]
    assert results[3] is True  # another batch is not touched


def test_batching_window_opens_again_after_a_flush(passes):
    """Requests that come after a flush form the next batch."""
    service = srv.BatchingService(window_ms=20.0, device="cpu")

    async def run():
        first = await asyncio.gather(*(service.submit("prove", 4, i) for i in range(3)))
        second = await asyncio.gather(*(service.submit("prove", 4, i) for i in range(3, 5)))
        return first, second

    service.start()
    try:
        first, second = asyncio.run(asyncio.wait_for(run(), timeout=60))
    finally:
        service.close()
    assert [items for _, items, _, _ in passes] == [[0, 1, 2], [3, 4]]
    assert len(first) == 3 and len(second) == 2


def test_a_pass_logs_its_requests_and_runs_under_a_span(passes, caplog):
    """Three requests inside one window: one pass under `server.pass`, and
    one DEBUG line with its kind, list length, batch size, request ids,
    queue waits (the first request waited the window) and seconds."""
    caplog.set_level(logging.DEBUG, logger="blindbid.server")
    service = srv.BatchingService(window_ms=50.0, device="cpu")
    profiling.reset()
    profiling.enable(True)
    try:
        _submit_all(service, [("prove", 4, f"req{i}") for i in range(3)])
        spans = [r for r in profiling.records() if r.name == "server.pass"]
    finally:
        profiling.enable(False)
        profiling.reset()
    assert [items for _, items, _, _ in passes] == [["req0", "req1", "req2"]]
    lines = [r.getMessage() for r in caplog.records
             if r.name == "blindbid.server" and r.levelno == logging.DEBUG]
    assert len(lines) == 1
    m = re.fullmatch(r"pass (\d+) prove: list length 4, batch 3, requests \[1, 2, 3\], "
                     r"queue wait ([\d.]+) to ([\d.]+) ms, ([\d.]+) s", lines[0])
    assert m, lines[0]
    oldest, newest, seconds = (float(g) for g in m.groups()[1:])
    assert oldest >= newest >= 0.0 and oldest >= 40.0
    assert len(spans) == 1 and spans[0].pass_id == int(m.group(1))
    assert spans[0].parent is None
    assert seconds >= (spans[0].end_ns - spans[0].start_ns) / 1e9


def test_batching_needs_start():
    service = srv.BatchingService(device="cpu")
    with pytest.raises(RuntimeError, match="start"):
        asyncio.run(service.submit("prove", 4, "a"))


# ---------------------------------------------------------------------------
# Start-up and the live daemon
# ---------------------------------------------------------------------------


def test_default_device_start_raises_and_leaves_no_socket():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bb.sock")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            asyncio.run(srv.BlindBidServer(path).start())
        with pytest.raises(RuntimeError, match="no CUDA device"):
            asyncio.run(srv.BlindBidServer(path).serve_forever())
        assert not os.path.exists(path)


def _serve(service, talk):
    """Run a live server on a fresh Unix socket while `talk(path)` runs in a
    thread; returns (talk's result, the server).  serve_forever's own
    exception, if any, is raised."""
    async def run(path):
        server = srv.BlindBidServer(path, service)
        serving = asyncio.ensure_future(server.serve_forever())
        while not os.path.exists(path) and not serving.done():
            await asyncio.sleep(0.005)
        try:
            out = None if serving.done() else await asyncio.to_thread(talk, path)
        finally:
            server.stop()
            await serving
        assert not os.path.exists(path)
        return out, server

    with tempfile.TemporaryDirectory() as tmp:
        return asyncio.run(asyncio.wait_for(run(os.path.join(tmp, "bb.sock")), timeout=3600))


def _connect(path):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(3600)
    s.connect(path)
    return s


def test_live_server_answers_over_a_unix_socket(passes):
    prove_req, _ = _load("session_prove.bin")
    verify_req, verify_resp = _load("session_verify.bin")

    def talk(path):
        with _connect(path) as s:
            return [client.send_frame(s, p) for p in
                    (verify_req, prove_req, b"\x09", prove_req[:40], verify_req)]

    out, server = _serve(srv.BatchingService(device="cpu"), talk)
    assert out[0] == out[4] == TlvReader(verify_resp).expect_frame("status") == b"\x01"
    assert srv.decode_proof(out[1]) == _dummy_proof(tag=0)
    assert out[2] == out[3] == srv.ERROR_FRAME  # and the daemon lived to answer out[4]
    assert server.fault is None
    assert [(kind, len(items)) for kind, items, _, _ in passes] == [
        ("verify", 1), ("prove", 1), ("verify", 1)]
    assert passes[1][1] == [srv.parse_prove_request(prove_req[1:])]


def test_live_server_drops_a_connection_without_frame_boundary(passes):
    """A length prefix that never ends leaves nothing to answer: the
    connection is closed, and the daemon answers the next one."""
    verify_req, _ = _load("session_verify.bin")

    def talk(path):
        with _connect(path) as s:
            s.sendall(b"\x80" * 11)
            closed = s.recv(16)
        with _connect(path) as s:
            return closed, client.send_frame(s, verify_req)

    out, server = _serve(srv.BatchingService(device="cpu"), talk)
    assert out == (b"", b"\x01")
    assert server.fault is None


def test_live_server_batches_concurrent_connections(passes):
    """Five clients at once, each with a request of its own: one pass of 5,
    and each gets its own answer."""
    bodies = [client.build_prove_body(d=10 + i, k=20 + i, seed=30 + i, extra=[1, 2, 3], pos=i % 4)
              for i in range(5)]
    start = threading.Barrier(5)

    def one(path, i, out):
        with _connect(path) as s:
            start.wait(timeout=60)
            out[i] = client.request(s, client.OP_PROVE, bodies[i][0])

    def talk(path):
        out = [None] * 5
        threads = [threading.Thread(target=one, args=(path, i, out)) for i in range(5)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        return out

    out, _ = _serve(srv.BatchingService(window_ms=500.0, device="cpu"), talk)
    assert [len(items) for _, items, _, _ in passes] == [5]
    order = [passes[0][1].index(srv.parse_prove_request(b[0])) for b in bodies]
    assert sorted(order) == list(range(5))
    assert [srv.decode_proof(f) for f in out] == [_dummy_proof(tag=i) for i in order]


def test_live_server_stops_on_a_device_fault(monkeypatch):
    """A KernelError of the pass fails the request with the error frame and
    ends serve_forever with that exception."""
    boom = fused.KernelError("kernel madd_scan failed to launch: cudaError 700")

    def broken(items, device=None):
        raise boom

    monkeypatch.setattr(blindbid, "prove_batch", broken)
    prove_req, _ = _load("session_prove.bin")

    def talk(path):
        with _connect(path) as s:
            return client.send_frame(s, prove_req)

    with pytest.raises(fused.KernelError, match="madd_scan failed to launch"):
        _serve(srv.BatchingService(device="cpu"), talk)


def _torch_shape_error() -> RuntimeError:
    """What torch raised for the unguarded pad of an over-capacity circuit."""
    try:
        torch.zeros((1, 2048 - 4096, limb.NLIMBS), dtype=torch.int32)
    except RuntimeError as exc:
        return exc
    raise AssertionError("torch accepted a negative dimension")


def test_live_server_serves_on_after_a_torch_shape_error(passes, monkeypatch):
    """A plain RuntimeError of a pass (here torch's own shape check) is the
    request's error frame, not a device fault: the daemon answers the next
    request."""
    shape_error = _torch_shape_error()
    assert type(shape_error) is RuntimeError and not srv._is_device_fault(shape_error)

    def broken(items, device=None):
        raise shape_error

    monkeypatch.setattr(blindbid, "prove_batch", broken)
    prove_req, _ = _load("session_prove.bin")
    verify_req, _ = _load("session_verify.bin")

    def talk(path):
        with _connect(path) as s:
            return [client.send_frame(s, p) for p in (prove_req, verify_req, prove_req)]

    out, server = _serve(srv.BatchingService(device="cpu"), talk)
    assert out == [srv.ERROR_FRAME, b"\x01", srv.ERROR_FRAME]
    assert server.fault is None
    assert [kind for kind, _, _, _ in passes] == ["verify"]


# ---------------------------------------------------------------------------
# Hostile requests through the real passes on the CPU: refused before any
# table or tensor work, each with the error frame, and the daemon serves on
# ---------------------------------------------------------------------------

OVER_CAPACITY_BIDS = 203  # n1 = 1442 + 3 * 203 = 2051 gates, n_pad = 4096 > 2048
# n1 = 1442 + 3 * 20000 = 61442 gates, n_pad = 65536 (16 IPA rounds): minutes to
# synthesize, so it must be refused from its length
LONG_LIST_BIDS = 20000
BASEPOINT = curve_host.ristretto_compress(curve_host.RISTRETTO_BASEPOINT)


def _basepoint_verify(n_bids: int, rounds: int, a_i1: bytes = BASEPOINT) -> bytes:
    """An opcode-2 request whose points are the Ristretto basepoint's encoding
    (A_I1 as given) and whose scalars are canonical."""
    pts = {k: BASEPOINT for k in ("A_O1", "S1", "T_1", "T_3", "T_4", "T_5", "T_6")}
    r1cs = R1CSProof(A_I1=a_i1, **pts, A_I2=IDENTITY_COMPRESSED, A_O2=IDENTITY_COMPRESSED,
                     S2=IDENTITY_COMPRESSED, t_x=1, t_x_blinding=2, e_blinding=3,
                     ipp_L=[BASEPOINT] * rounds, ipp_R=[BASEPOINT] * rounds, ipp_a=4, ipp_b=5)
    proof = BlindBidProof(r1cs=r1cs, commitments=[BASEPOINT] * 4, t_c=[BASEPOINT] * n_bids)
    return b"\x02" + _verify_body(proof, scalars=(7, 8, 9),
                                   pub_list=range(1000, 1000 + n_bids))


HOSTILE = {
    "verify-203": lambda: _basepoint_verify(OVER_CAPACITY_BIDS, 12),
    "prove-203": lambda: b"\x01" + _prove_body(pub_list=range(1000, 1000 + OVER_CAPACITY_BIDS),
                                                toggle=0),
    "verify-0": lambda: _basepoint_verify(0, 11),
    "rounds-10": lambda: _basepoint_verify(4, 10),
    "odd-A_I1": lambda: _basepoint_verify(4, 11, a_i1=bytes([BASEPOINT[0] | 1]) + BASEPOINT[1:]),
    "prove-20000": lambda: b"\x01" + _prove_body(pub_list=range(1000, 1000 + LONG_LIST_BIDS),
                                                  toggle=0),
    "verify-20000": lambda: _basepoint_verify(LONG_LIST_BIDS, 16),
}
# the requests refused from their list's length, before any synthesis, table
# or pass
NO_TABLES = ("verify-203", "prove-203", "verify-0", "prove-20000", "verify-20000")


@pytest.fixture
def device_calls(monkeypatch):
    """generator_tables stubbed, and it and the device phases of the prover
    and verifier recorded, and the synthesis of any circuit but the usual
    list length's: a refused request reaches none of them.  A phase that is
    reached also raises, which the server would only answer with the error
    frame: the record is what the tests read."""
    calls = []
    synthesize = blindbid.blindbid_circuit

    def synthesis(list_len, device="cpu"):
        if list_len != srv.LIST_LEN:
            calls.append(f"blindbid_circuit({list_len})")
            raise AssertionError(f"the circuit of {list_len} bids synthesized")
        return synthesize(list_len, device)

    monkeypatch.setattr(blindbid, "blindbid_circuit", synthesis)

    def recorder(name):
        def record(*args, **kwargs):
            calls.append(name)
            if name != "generator_tables":
                raise AssertionError(f"{name} reached by a refused request")
        return record

    monkeypatch.setattr(bulletproofs, "generator_tables", recorder("generator_tables"))
    for name in ("phase_a", "verify_scalars"):
        monkeypatch.setattr(bulletproofs, name, recorder(name))
    monkeypatch.setattr(bulletproofs.ristretto, "decompress", recorder("decompress"))
    monkeypatch.setattr(bulletproofs.msm, "msm", recorder("msm"))
    return calls


@pytest.mark.parametrize("name", NO_TABLES)
def test_dispatch_refuses_hostile_request_through_the_real_service(device_calls, caplog, name):
    """The real BatchingService on the CPU: the error frame, answered on the
    event loop without a submit to the service, nothing synthesized, no
    tables built, no fault kept, the server not stopped, and the refusal
    logged as an error of the request, without a traceback."""
    service = srv.BatchingService(device="cpu")
    submitted = []
    submit = service.submit

    async def recording_submit(kind, shape_key, item):
        submitted.append((kind, shape_key))
        return await submit(kind, shape_key, item)

    service.submit = recording_submit
    service.start()
    try:
        frame, server = _dispatch(service, HOSTILE[name]())
    finally:
        service.close()
    assert frame == srv.ERROR_FRAME
    assert server.fault is None and not server._stop.is_set()
    assert device_calls == [] and submitted == []
    errors = [r for r in caplog.records if r.name == "blindbid.server"]
    assert [r.levelname for r in errors] == ["ERROR"]
    assert errors[0].exc_info is None
    why = "empty bid list" if name == "verify-0" else "exceeds generator capacity"
    assert why in errors[0].getMessage()


def test_live_server_answers_hostile_requests_and_serves_on(device_calls):
    """A live CPU daemon with the real passes: each hostile request answers
    the error frame, the over-capacity pair and the empty list before any
    table is built, and the daemon answers every next request."""
    def talk(path):
        with _connect(path) as s:
            return {name: client.send_frame(s, make()) for name, make in HOSTILE.items()}

    out, server = _serve(srv.BatchingService(device="cpu"), talk)
    assert out == {name: srv.ERROR_FRAME for name in HOSTILE}
    assert server.fault is None
    # only the two list-length-4 requests made a verifier, and neither
    # reached a device phase
    assert device_calls == ["generator_tables", "generator_tables"]


def test_live_server_refuses_a_long_list_while_a_pass_holds_the_device_thread(device_calls,
                                                                             monkeypatch):
    """A prove pass that blocks on an event holds the service's one worker
    thread; while it is held, the 20,000-bid requests on a second connection
    are answered 0xff (refused on the event loop, never queued), and only
    then is the pass released and its own request answered."""
    started, release = threading.Event(), threading.Event()

    def held(items, device=None):
        started.set()
        if not release.wait(timeout=60):
            raise AssertionError("the held pass was never released")
        return [_dummy_proof(tag=i) for i in range(len(items))]

    monkeypatch.setattr(blindbid, "prove_batch", held)
    prove_req, _ = _load("session_prove.bin")

    def talk(path):
        with _connect(path) as first, _connect(path) as second:
            try:
                first.sendall(client.frame(prove_req))
                assert started.wait(timeout=60), "the held pass did not start"
                refused = {name: client.send_frame(second, HOSTILE[name]())
                           for name in ("prove-20000", "verify-20000")}
                released_before = release.is_set()
            finally:
                release.set()
            return refused, released_before, client.read_frame(first)

    (refused, released_before, held_answer), server = _serve(
        srv.BatchingService(device="cpu"), talk)
    assert refused == {"prove-20000": srv.ERROR_FRAME, "verify-20000": srv.ERROR_FRAME}
    assert not released_before
    assert srv.decode_proof(held_answer) == _dummy_proof(tag=0)
    assert server.fault is None
    assert device_calls == []


# ---------------------------------------------------------------------------
# slow: the whole slice at n = 2048 on the CPU against the recorded bytes
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_recorded_prove_request_reproduces_the_recorded_proof():
    """parse -> prove_batch(rng = default_rng(2026)) -> encode: the bytes the
    JAX package recorded."""
    request, response = _load("session_prove.bin")
    req = srv.parse_prove_request(request[1:])
    proofs = blindbid.prove_batch([req], rng=np.random.default_rng(2026), device="cpu")
    w = TlvWriter()
    w.write(srv.encode_proof(proofs[0]))
    assert w.getvalue() == response


@pytest.mark.slow
def test_server_live_session_replay():
    """The real passes behind a live daemon on the CPU: the recorded proof
    verifies with the recorded response bytes, a changed seed gives 0x00."""
    verify_req, verify_resp = _load("session_verify.bin")
    vreq = srv.parse_verify_request(verify_req[1:])
    pub = dict(q=vreq.score, z_img=vreq.z_img, seed=vreq.seed + 1, pub_list=vreq.pub_list)
    proof_frame = TlvReader(verify_req[1:]).expect_frame("proof")

    def talk(path):
        with _connect(path) as s:
            good = client.send_frame(s, verify_req)
            bad = client.request(s, client.OP_VERIFY, client.build_verify_body(proof_frame, pub))
            return good, bad

    (good, bad), server = _serve(srv.BatchingService(device="cpu"), talk)
    w = TlvWriter()
    w.write(good)
    assert w.getvalue() == verify_resp
    assert bad == b"\x00"
    assert server.fault is None
