"""Batches that are not a power of two: the port's `Prover` and `Verifier` at
B = 3 and B = 5 on the CPU, on the CAP = 32 power-chain circuit of
tests/test_torch_bulletproofs.py with a witness of its own in every place.

The JAX package pads a batch to a power of two; the port runs it as it
arrives, as its server does for whatever came inside a window.  Every proof
of a batch must be the proof its place alone would give (the bytes of the JAX
package's host oracle), be accepted by the JAX package's `host_verify` and by
the port's `Verifier` at the same B, and a tampered proof must turn the
verdict of its own place only.  Tolerance: none, bytes and booleans.
"""

import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu.models import r1cs as jr1cs
from dusk_blindbidproof_tpu.models.proof_struct import R1CSProof as JaxR1CSProof
from dusk_blindbidproof_tpu.utils import host_oracle as oracle
from dusk_blindbidproof_tpu.utils.merlin import Transcript as JaxTranscript
from dusk_blindbidproof_tpu_torch.models import r1cs as tr1cs
from dusk_blindbidproof_tpu_torch.models.bulletproofs import (
    CompiledCircuit,
    Prover,
    ProverWitness,
    Verifier,
)
from dusk_blindbidproof_tpu_torch.models.proof_struct import R1CSProof
from dusk_blindbidproof_tpu_torch.ops import limb
from dusk_blindbidproof_tpu_torch.utils.curve_host import L
from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript

torch.set_num_threads(1)

CAP = 32
GATES = 20
LABEL = b"torch-port-batch"
BATCHES = (3, 5)
PLACES = [(B, i) for B in BATCHES for i in range(B)]


def _artifact(r1cs):
    cs = r1cs.VerifierCS()
    a = cs.commit_var()
    pub = cs.public_var()
    x = r1cs.LC.of(a)
    for _ in range(GATES):
        _, _, o = cs.multiply(x, r1cs.LC.of(a))
        x = r1cs.LC.of(o)
    cs.constrain(x - pub)
    return cs.artifact()


def _place(i):
    """The committed value, its blinding and the chain's gates at place i."""
    a, blind = 987654321 + 1000003 * i, 4242 + i
    a_L, a_R, a_O, x = [], [], [], a
    for _ in range(GATES):
        a_L.append(x)
        a_R.append(a)
        x = x * a % L
        a_O.append(x)
    return a, blind, a_L, a_R, a_O, x


def _limbs(vals, shape):
    return limb.ints_to_limbs_fast(vals, shape)


@pytest.fixture(scope="module")
def circuit():
    return CompiledCircuit.compile(_artifact(tr1cs), torch.device("cpu"))


@pytest.fixture(scope="module")
def batches(circuit):
    """{B: (proofs, commitments, publics)} from one `Prover` pass at each B."""
    out = {}
    for B in BATCHES:
        places = [_place(i) for i in range(B)]
        prover = Prover([Transcript(LABEL) for _ in range(B)], cap=CAP, device="cpu")
        commitments = prover.commit_batch([[p[0]] for p in places], [[p[1]] for p in places])

        def rows(k):
            arr = np.zeros((B, circuit.n_pad, limb.NLIMBS), dtype=np.int32)
            for i, p in enumerate(places):
                arr[i, :GATES] = limb.ints_to_limbs_fast(p[k])
            return arr

        witness = ProverWitness(
            a_L=rows(2), a_R=rows(3), a_O=rows(4),
            v=_limbs([p[0] for p in places], (B, 1)),
            v_blinding=_limbs([p[1] for p in places], (B, 1)),
            publics=_limbs([p[5] for p in places], (B, 1)),
        )
        out[B] = (prover.prove(circuit, witness), commitments, [p[5] for p in places])
    return out


def _verify(circuit, proofs, commitments, publics):
    B = len(proofs)
    verifier = Verifier([Transcript(LABEL) for _ in range(B)], cap=CAP, device="cpu")
    verifier.commit_batch(commitments)
    return verifier.verify(circuit, proofs, commitments, _limbs(publics, (B, 1)))


# the places of a batch that the tampered pass changes: t_x of the proof at
# place 1 at both sizes, and at B = 5 the public input of the last place too
TAMPERED = {3: {1: "t_x"}, 5: {1: "t_x", 4: "public"}}


@pytest.fixture(scope="module")
def verdicts(circuit, batches):
    """{B: (verdicts of the honest batch, verdicts of the tampered batch)}:
    two `Verifier` passes at each B."""
    out = {}
    for B, (proofs, commitments, publics) in batches.items():
        bad_proofs = [R1CSProof.from_bytes(p.to_bytes()) for p in proofs]
        bad_publics = list(publics)
        for i, what in TAMPERED[B].items():
            if what == "t_x":
                bad_proofs[i].t_x = (bad_proofs[i].t_x + 1) % L
            else:
                bad_publics[i] = (bad_publics[i] + 1) % L
        out[B] = (_verify(circuit, proofs, commitments, publics),
                  _verify(circuit, bad_proofs, commitments, bad_publics))
    return out


@pytest.mark.parametrize("B, i", PLACES)
def test_batch_proof_is_the_proof_of_its_place(batches, B, i):
    """Place i of a batch of B: the host oracle's bytes for that witness alone."""
    proofs, commitments, _ = batches[B]
    a, blind, a_L, a_R, a_O, out = _place(i)
    want, trace = oracle.host_prove(_artifact(jr1cs), JaxTranscript(LABEL), [a], [blind],
                                    a_L, a_R, a_O, [out], CAP)
    assert commitments[i] == trace.commitments
    assert proofs[i].to_bytes() == want.to_bytes()


@pytest.mark.parametrize("B, i", PLACES)
def test_batch_proof_accepted_by_host_verify(batches, B, i):
    proofs, commitments, publics = batches[B]
    jproof = JaxR1CSProof.from_bytes(proofs[i].to_bytes())
    assert oracle.host_verify(_artifact(jr1cs), JaxTranscript(LABEL), jproof,
                              commitments[i], [publics[i]], CAP)


@pytest.mark.parametrize("B", BATCHES)
def test_batch_accepted_by_the_port_verifier(verdicts, B):
    assert verdicts[B][0] == [True] * B


@pytest.mark.parametrize("B, i", PLACES)
def test_tampering_turns_the_verdict_of_its_place_only(verdicts, B, i):
    assert verdicts[B][1][i] == (i not in TAMPERED[B])
