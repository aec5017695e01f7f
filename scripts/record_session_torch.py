"""Record the prove and the verify session at the wire-byte level with the
PyTorch/CUDA port, and hold them to the frozen sessions of tests/data.

Builds the same round trips as scripts/record_session.py (the JAX package's
recorder): one prove request with rng = default_rng(2026) and its response,
one verify request for that proof and its response.  A session file is two
TLV frames, the request WITHOUT and the response WITH its own length prefix.
The files go to --out, never into tests/data; the script exits non-zero
unless their bytes equal tests/data/session_{prove,verify}.bin.

Usage:
    python scripts/record_session_torch.py                      # on the GPU
    python scripts/record_session_torch.py --device cpu --out DIR
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from dusk_blindbidproof_tpu_torch.models.blindbid import (  # noqa: E402
    VerifyRequest,
    make_prove_request,
    prove_batch,
    verify_batch,
)
from dusk_blindbidproof_tpu_torch.server import (  # noqa: E402
    OP_PROVE,
    OP_VERIFY,
    encode_proof,
    parse_prove_request,
    parse_verify_request,
)
from dusk_blindbidproof_tpu_torch.utils.tlv import TlvWriter  # noqa: E402

FROZEN = ROOT / "tests" / "data"
RNG_SEED = 2026


def sessions(device) -> dict[str, bytes]:
    """{file name: session bytes} of the prove and the verify round trip."""
    req = make_prove_request(d=123456789, k=987654321, seed=42424242,
                             pub_list_extra=[1111, 2222, 3333], toggle_pos=1)

    body = TlvWriter()
    for v in (req.d, req.k, req.y, req.y_inv, req.q, req.z_img, req.seed):
        body.write_scalar(v)
    body.write_list([x.to_bytes(32, "little") for x in req.pub_list])
    body.write_u64(req.toggle)
    prove_request = bytes([OP_PROVE]) + body.getvalue()
    if parse_prove_request(prove_request[1:]) != req:
        raise AssertionError("the prove request does not round-trip through the codec")

    proofs = prove_batch([req], rng=np.random.default_rng(RNG_SEED), device=device)
    proof_frame = encode_proof(proofs[0])
    w = TlvWriter()
    w.write(proof_frame)
    prove_response = w.getvalue()

    body = TlvWriter()
    body.write(proof_frame)
    for v in (req.q, req.z_img, req.seed):
        body.write_scalar(v)
    body.write_list([x.to_bytes(32, "little") for x in req.pub_list])
    verify_request = bytes([OP_VERIFY]) + body.getvalue()
    vreq = parse_verify_request(verify_request[1:])
    if vreq != VerifyRequest(proof=proofs[0], score=req.q, z_img=req.z_img,
                             seed=req.seed, pub_list=req.pub_list):
        raise AssertionError("the verify request does not round-trip through the codec")
    if verify_batch([vreq], device=device) != [True]:
        raise AssertionError("the recorded proof does not verify")
    w = TlvWriter()
    w.write(b"\x01")
    verify_response = w.getvalue()

    out = {}
    for name, request, response in (("session_prove.bin", prove_request, prove_response),
                                    ("session_verify.bin", verify_request, verify_response)):
        w = TlvWriter()
        w.write(request)
        w.write(response)
        out[name] = w.getvalue()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    ap.add_argument("--out", default=str(ROOT / "build" / "sessions"),
                    help="directory for the recorded files (never tests/data)")
    args = ap.parse_args(argv)
    out_dir = Path(args.out).resolve()
    if out_dir == FROZEN.resolve():
        ap.error("--out must not be tests/data: the frozen sessions are read, never written")

    recorded = sessions(args.device)
    out_dir.mkdir(parents=True, exist_ok=True)
    same = True
    for name, data in recorded.items():
        path = out_dir / name
        path.write_bytes(data)
        frozen = (FROZEN / name).read_bytes()
        equal = data == frozen
        same &= equal
        print(f"wrote {path} ({len(data)} bytes): "
              f"{'equal to' if equal else 'DIFFERS from'} tests/data/{name}")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
