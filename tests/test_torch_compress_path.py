"""The prover's compression path, on the CPU.

The prover compresses the points of its four transcript boundaries (the
commitments V; A_I1, A_O1, S1; T_1, T_3 .. T_6; each IPA round's L and R)
through `fused.compress`, one call a boundary, and reads back their
encodings alone: one kernel launch on a card, the plain version
`fused.compress_ref` on the CPU.  Here a spy on `fused.compress` records the
[B, k] point shapes of each call while the CPU prover proves at CAP <= 32:
the calls come once a boundary in transcript order, and the proofs come out
byte for byte (the JAX package's host oracle, the frozen cube vector).  The
full-size frozen vectors take the same path in their `slow` tests.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import bulletproofs as bp  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import r1cs as tr1cs  # noqa: E402
from dusk_blindbidproof_tpu_torch.ops import fused, limb  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript  # noqa: E402
from test_torch_ipa_sizes import jax_chain_proof  # noqa: E402
from test_transcript_protocol import (  # noqa: E402
    A_VAL,
    BLIND,
    CAP,
    FROZEN_PROOF,
    FROZEN_V,
    LABEL,
    cube_inputs,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def compress_calls(monkeypatch):
    """`fused.compress` spied on: returns the [B, k] point shapes it was
    called with, in order."""
    calls = []
    compress = fused.compress

    def spy(points):
        assert points.shape[-2:] == (4, limb.NLIMBS)
        calls.append(tuple(points.shape[:-2]))
        return compress(points)

    monkeypatch.setattr(fused, "compress", spy)
    return calls


def test_chain_proofs_through_fused_compress(compress_calls):
    """n = cap = 16, B = 2: both proofs equal the JAX host oracle's."""
    n, B = 16, 2
    artifact, *wit = chip_smoke.chain_inputs(n)
    circuit = bp.CompiledCircuit.compile(artifact, CPU)
    commitments, proofs = chip_smoke.chain_prove(
        circuit, chip_smoke.chain_witness(n, B, *wit), n, CPU)
    want, want_commitments = jax_chain_proof(n, n)
    assert commitments == [want_commitments] * B
    assert [p.to_bytes() for p in proofs] == [want.to_bytes()] * B
    assert compress_calls == [(B, 1), (B, 3), (B, 5)] + [(B, 2)] * 4


def test_cube_proof_through_fused_compress(compress_calls):
    """The CAP = 8 cube circuit (n_pad = 2, one IPA round): the frozen
    vectors of tests/test_transcript_protocol.py."""
    cs = tr1cs.VerifierCS()
    a = cs.commit_var()
    pub = cs.public_var()
    _, _, o = cs.multiply(tr1cs.LC.of(a), tr1cs.LC.of(a))
    _, _, o2 = cs.multiply(tr1cs.LC.of(o), tr1cs.LC.of(a))
    cs.constrain(tr1cs.LC.of(o2) - pub)
    circuit = bp.CompiledCircuit.compile(cs.artifact(), CPU)
    a2, a3 = cube_inputs()
    prover = bp.Prover([Transcript(LABEL)], cap=CAP, device=CPU)
    commitments = prover.commit_batch([[A_VAL]], [[BLIND]])

    def limbs(vals):
        return limb.ints_to_limbs_fast(vals, (1, len(vals)))

    witness = bp.ProverWitness(a_L=limbs([A_VAL, a2]), a_R=limbs([A_VAL, A_VAL]),
                               a_O=limbs([a2, a3]), v=limbs([A_VAL]),
                               v_blinding=limbs([BLIND]), publics=limbs([a3]))
    proof = prover.prove(circuit, witness)[0]
    assert commitments[0][0].hex() == FROZEN_V
    assert proof.to_bytes().hex() == FROZEN_PROOF
    assert compress_calls == [(1, 1), (1, 3), (1, 5), (1, 2)]
