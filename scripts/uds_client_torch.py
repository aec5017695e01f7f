"""Black-box client of the PyTorch/CUDA port's Unix-socket server.

Connects to a live `dusk_blindbidproof_tpu_torch.server` and speaks ONLY wire
bytes (opcode 1 = prove, opcode 2 = verify): a pass exercises the codec, the
dispatch, the batching queue, the device prover and verifier and the
serialization.  It imports the port's host modules alone (no torch, no
prover), and `chip_smoke.py` drives its server phase through these functions.

Usage:
    python scripts/uds_client_torch.py --bind-path /tmp/bb.sock            # 1 round trip
    python scripts/uds_client_torch.py --bind-path /tmp/bb.sock --bench 8  # timed ops
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from dusk_blindbidproof_tpu_torch.models.constants import mimc_constants  # noqa: E402
from dusk_blindbidproof_tpu_torch.models.gadgets import mimc_hash  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils.curve_host import L, scalar_invert  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils.tlv import TlvReader, TlvWriter  # noqa: E402

LIST_LEN = 4
OP_PROVE, OP_VERIFY = 1, 2
ERROR_FRAME = b"\xff"


def build_prove_body(d: int, k: int, seed: int, extra: list[int], pos: int) -> tuple[bytes, dict]:
    """Derive consistent publics the way the canonical Go client does and
    TLV-encode an opcode-1 body; also returns the publics a verifier needs."""
    consts = mimc_constants()
    m = mimc_hash(k, 0, consts)
    x = mimc_hash(d, m, consts)
    y = mimc_hash(seed, x, consts)
    z = mimc_hash(seed, m, consts)
    y_inv = scalar_invert(y)
    q = d * y_inv % L
    pub_list = list(extra)
    pub_list.insert(pos, x)
    w = TlvWriter()
    for v in (d, k, y, y_inv, q, z, seed):
        w.write_scalar(v)
    w.write_list([v.to_bytes(32, "little") for v in pub_list])
    w.write_u64(pos)
    return w.getvalue(), dict(q=q, z_img=z, seed=seed, pub_list=pub_list)


def build_verify_body(proof_frame: bytes, pub: dict) -> bytes:
    w = TlvWriter()
    w.write(proof_frame)
    for v in (pub["q"], pub["z_img"], pub["seed"]):
        w.write_scalar(v)
    w.write_list([v.to_bytes(32, "little") for v in pub["pub_list"]])
    return w.getvalue()


def frame(payload: bytes) -> bytes:
    w = TlvWriter()
    w.write(payload)
    return w.getvalue()


def read_frame(sock: socket.socket) -> bytes:
    """The payload of the next frame the server sends."""
    with sock.makefile("rb") as stream:
        return TlvReader(stream).expect_frame("response")


def send_frame(sock: socket.socket, payload: bytes) -> bytes:
    """One framed round trip: `payload` (opcode byte and body) goes out as one
    TLV frame, the payload of the answering frame comes back."""
    sock.sendall(frame(payload))
    return read_frame(sock)


def request(sock: socket.socket, opcode: int, body: bytes) -> bytes:
    return send_frame(sock, bytes([opcode]) + body)


def prove_verify(sock: socket.socket, body: bytes, pub: dict) -> bytes:
    """Opcode 1 with `body`, then opcode 2 with the proof that came back and
    the publics `pub`.  Returns the proof frame; raises on an error frame or
    a proof that does not verify."""
    proof_frame = request(sock, OP_PROVE, body)
    if proof_frame == ERROR_FRAME:
        raise RuntimeError("server answered the error frame to a prove request")
    ok = request(sock, OP_VERIFY, build_verify_body(proof_frame, pub))
    if ok != b"\x01":
        raise RuntimeError(f"verify did not accept an honest proof: {ok!r}")
    return proof_frame


def round_trip(path: str, seed_base: int) -> None:
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.connect(path)
        body, pub = build_prove_body(
            d=1000 + seed_base, k=2000 + seed_base, seed=3000 + seed_base,
            extra=[10 + i for i in range(LIST_LEN - 1)],
            pos=seed_base % LIST_LEN,
        )
        proof_frame = prove_verify(s, body, pub)
        # a changed seed must be rejected with a clean 0x00 (not an error frame)
        bad = dict(pub, seed=(pub["seed"] + 1) % L)
        not_ok = request(s, OP_VERIFY, build_verify_body(proof_frame, bad))
        if not_ok != b"\x00":
            raise RuntimeError(f"verify accepted changed publics: {not_ok!r}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bind-path", required=True)
    ap.add_argument("--bench", type=int, default=0,
                    help="run N timed prove+verify+reject round trips, one after another")
    args = ap.parse_args()

    if args.bench:
        round_trip(args.bind_path, 0)  # warm-up
        t0 = time.perf_counter()
        for i in range(args.bench):
            round_trip(args.bind_path, i)
        dt = time.perf_counter() - t0
        print(f"BenchmarkProveVerify  {args.bench} ops  "
              f"{dt / args.bench:.3f} s/op")
    else:
        round_trip(args.bind_path, 0)
        print("TestProveVerify PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
