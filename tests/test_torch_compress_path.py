"""The prover's compression path, on the CPU.

A CUDA prover compresses the points of its four transcript boundaries (the
commitments V; A_I1, A_O1, S1; T_1, T_3 .. T_6; each IPA round's L and R) on
the card, one `fused.compress` launch a boundary, and reads back their
encodings alone.  Here `bulletproofs.DEVICE_COMPRESS` points the CPU at the
kernel's plain version, `fused.compress_ref`, so that a CPU prove takes that
path: the frozen proofs come out byte for byte, the hook is called once a
boundary in transcript order, and the host's compression is never called.
Each test proves at full size on the CPU: about two and a half minutes at
n = 2048 and one and a half at n = 1024, most of it the generator tables.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import blindbid  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import bulletproofs as bp  # noqa: E402
from dusk_blindbidproof_tpu_torch.ops import fused, limb  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
FROZEN_L4 = ROOT / "tests" / "data" / "blindbid_L4_seed42.hex"


@pytest.fixture
def device_path(monkeypatch):
    """The CPU prover compresses through the device hook; returns the [B, k]
    point shapes the hook was called with, in order."""
    calls = []

    def compress(points):
        assert points.shape[-2:] == (4, limb.NLIMBS)
        calls.append(tuple(points.shape[:-2]))
        return fused.compress_ref(points)

    def no_host_compression(arr):
        raise AssertionError("the host compressed points the device hook was to compress")

    monkeypatch.setitem(bp.DEVICE_COMPRESS, "cpu", compress)
    monkeypatch.setattr(bp, "_compress_host", no_host_compression)
    return calls


def test_blindbid_l4_proof_through_the_device_hook(device_path):
    req = blindbid.make_prove_request(
        d=123456789, k=987654321, seed=55555,
        pub_list_extra=[1000 + i for i in range(3)], toggle_pos=2)
    proof = blindbid.prove_batch([req], rng=np.random.default_rng(42), device=CPU)[0]
    assert blindbid.proof_blob(proof) == bytes.fromhex(FROZEN_L4.read_text().strip())
    rounds = len(proof.r1cs.ipp_L)
    assert rounds == 11
    assert device_path == [(1, 8), (1, 3), (1, 5)] + [(1, 2)] * rounds


def test_chain_n1024_proof_through_the_device_hook(device_path):
    n = chip_smoke.CHAIN_SMALL
    artifact, *wit = chip_smoke.chain_inputs(n)
    circuit = bp.CompiledCircuit.compile(artifact, CPU)
    _, proofs = chip_smoke.chain_prove(circuit, chip_smoke.chain_witness(n, 1, *wit), n, CPU)
    assert proofs[0].to_bytes().hex() == chip_smoke.FROZEN_CHAIN.read_text().strip()
    assert device_path == [(1, 1), (1, 3), (1, 5)] + [(1, 2)] * 10
