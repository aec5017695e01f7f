"""The port's R1CS prover and verifier against the JAX package.

  * the CAP = 8 cube circuit reproduces the frozen vectors of
    tests/test_transcript_protocol.py byte for byte;
  * a 20-gate circuit at CAP = 32 gives the same proof bytes as the JAX
    package's host oracle (`host_prove`), and the port's verifier agrees with
    `host_verify` on the honest proof and on mutations.

Everything runs on the CPU through the plain versions (device="cpu").
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu.models import r1cs as jr1cs
from dusk_blindbidproof_tpu.models.proof_struct import R1CSProof as JaxR1CSProof
from dusk_blindbidproof_tpu.utils import host_oracle as oracle
from dusk_blindbidproof_tpu.utils.merlin import Transcript as JaxTranscript
from dusk_blindbidproof_tpu_torch.models import bulletproofs as bp
from dusk_blindbidproof_tpu_torch.models import r1cs as tr1cs
from dusk_blindbidproof_tpu_torch.models.bulletproofs import (
    CompiledCircuit,
    Prover,
    ProverWitness,
    Verifier,
    resolve_device,
)
from dusk_blindbidproof_tpu_torch.models.proof_struct import R1CSProof
from dusk_blindbidproof_tpu_torch.models.transcript_protocol import ProofError
from dusk_blindbidproof_tpu_torch.ops import limb
from dusk_blindbidproof_tpu_torch.utils.curve_host import L
from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript
from test_transcript_protocol import (
    A_VAL,
    BLIND,
    CAP,
    FROZEN_PROOF,
    FROZEN_V,
    LABEL,
    cube_inputs,
)

# small tensors: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parent.parent


def _cube_circuit(r1cs):
    cs = r1cs.VerifierCS()
    a = cs.commit_var()
    pub = cs.public_var()
    _, _, o = cs.multiply(r1cs.LC.of(a), r1cs.LC.of(a))
    _, _, o2 = cs.multiply(r1cs.LC.of(o), r1cs.LC.of(a))
    cs.constrain(r1cs.LC.of(o2) - pub)
    return cs.artifact()


def _limbs(vals, shape):
    return limb.ints_to_limbs_fast(vals, shape)


def test_cube_reproduces_frozen_vectors():
    circuit = CompiledCircuit.compile(_cube_circuit(tr1cs), CPU)
    a2, a3 = cube_inputs()
    prover = Prover([Transcript(LABEL)], cap=CAP, device="cpu")
    commitments = prover.commit_batch([[A_VAL]], [[BLIND]])
    witness = ProverWitness(
        a_L=_limbs([A_VAL, a2], (1, 2)),
        a_R=_limbs([A_VAL, A_VAL], (1, 2)),
        a_O=_limbs([a2, a3], (1, 2)),
        v=_limbs([A_VAL], (1, 1)),
        v_blinding=_limbs([BLIND], (1, 1)),
        publics=_limbs([a3], (1, 1)),
    )
    proof = prover.prove(circuit, witness)[0]
    assert commitments[0][0].hex() == FROZEN_V
    assert proof.to_bytes().hex() == FROZEN_PROOF


# ---------------------------------------------------------------------------
# CAP = 32: a power chain x_{i+1} = x_i * a over 20 gates, public x_20
# ---------------------------------------------------------------------------

CHAIN_CAP = 32
CHAIN_GATES = 20
CHAIN_LABEL = b"torch-port-chain"
CHAIN_A, CHAIN_BLIND = 987654321, 4242


def _chain_artifact(r1cs):
    cs = r1cs.VerifierCS()
    a = cs.commit_var()
    pub = cs.public_var()
    x = r1cs.LC.of(a)
    for _ in range(CHAIN_GATES):
        _, _, o = cs.multiply(x, r1cs.LC.of(a))
        x = r1cs.LC.of(o)
    cs.constrain(x - pub)
    return cs.artifact()


def _chain_witness():
    a_L, a_R, a_O = [], [], []
    x = CHAIN_A
    for _ in range(CHAIN_GATES):
        a_L.append(x)
        a_R.append(CHAIN_A)
        x = x * CHAIN_A % L
        a_O.append(x)
    return a_L, a_R, a_O, x


@pytest.fixture(scope="module")
def chain():
    artifact = _chain_artifact(tr1cs)
    circuit = CompiledCircuit.compile(artifact, CPU)
    a_L, a_R, a_O, out = _chain_witness()
    n_pad = circuit.n_pad

    def pad(vals):
        arr = np.zeros((1, n_pad, limb.NLIMBS), dtype=np.int32)
        arr[0, : len(vals)] = limb.ints_to_limbs_fast(vals)
        return arr

    prover = Prover([Transcript(CHAIN_LABEL)], cap=CHAIN_CAP, device="cpu")
    commitments = prover.commit_batch([[CHAIN_A]], [[CHAIN_BLIND]])
    witness = ProverWitness(
        a_L=pad(a_L), a_R=pad(a_R), a_O=pad(a_O),
        v=_limbs([CHAIN_A], (1, 1)), v_blinding=_limbs([CHAIN_BLIND], (1, 1)),
        publics=_limbs([out], (1, 1)),
    )
    proof = prover.prove(circuit, witness)[0]
    return dict(circuit=circuit, proof=proof, commitments=commitments[0],
                out=out, witness=(a_L, a_R, a_O))


def _port_verify(chain, proof, public):
    verifier = Verifier([Transcript(CHAIN_LABEL)], cap=CHAIN_CAP, device="cpu")
    verifier.commit_batch([chain["commitments"]])
    return verifier.verify(chain["circuit"], [proof], [chain["commitments"]],
                           _limbs([public], (1, 1)))[0]


def _host_verify(chain, proof, public):
    jproof = JaxR1CSProof.from_bytes(proof.to_bytes())
    return oracle.host_verify(_chain_artifact(jr1cs), JaxTranscript(CHAIN_LABEL),
                              jproof, chain["commitments"], [public], CHAIN_CAP)


def test_chain_proof_matches_host_oracle(chain):
    a_L, a_R, a_O = chain["witness"]
    want, trace = oracle.host_prove(
        _chain_artifact(jr1cs), JaxTranscript(CHAIN_LABEL), [CHAIN_A],
        [CHAIN_BLIND], a_L, a_R, a_O, [chain["out"]], CHAIN_CAP,
    )
    assert chain["circuit"].n_pad == CHAIN_CAP
    assert trace.commitments == chain["commitments"]
    assert chain["proof"].to_bytes() == want.to_bytes()


def _mutations(proof):
    def mut(field, fn):
        p = R1CSProof.from_bytes(proof.to_bytes())
        setattr(p, field, fn(getattr(p, field)))
        return p

    return {
        "honest": (R1CSProof.from_bytes(proof.to_bytes()), 0),
        "t_x": (mut("t_x", lambda v: (v + 1) % L), 0),
        "ipp_a": (mut("ipp_a", lambda v: (v + 1) % L), 0),
        "T_3": (mut("T_3", lambda _: proof.T_4), 0),
        "public": (R1CSProof.from_bytes(proof.to_bytes()), 1),
    }


@pytest.mark.parametrize("case", ["honest", "t_x", "ipp_a", "T_3", "public"])
def test_verifier_agrees_with_host_verify(chain, case):
    proof, bump = _mutations(chain["proof"])[case]
    public = (chain["out"] + bump) % L
    got = _port_verify(chain, proof, public)
    assert got == _host_verify(chain, proof, public)
    assert got == (case == "honest")


def test_verifier_rejects_bad_encodings(chain):
    proof = R1CSProof.from_bytes(chain["proof"].to_bytes())
    proof.T_1 = b"\xff" * 32
    with pytest.raises(ProofError):
        _port_verify(chain, proof, chain["out"])


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        Prover([Transcript(LABEL)], cap=CAP)


# ---------------------------------------------------------------------------
# A circuit larger than the generator capacity: refused before any work
# ---------------------------------------------------------------------------

SMALL_CAP = 16  # below the chain circuit's n_pad = 32


@pytest.fixture
def no_tensor_work(monkeypatch):
    """The tables become a stub and every way to tensor work fails if taken:
    a refusal must come before all of it."""
    def untouched(*args, **kwargs):
        raise AssertionError("tensor work before the capacity check")

    monkeypatch.setattr(bp, "generator_tables", lambda cap, device: None)
    for name in ("_dev", "verify_scalars", "phase_a", "flatten_constraints"):
        monkeypatch.setattr(bp, name, untouched)
    monkeypatch.setattr(bp.msm, "msm", untouched)


def test_verifier_refuses_a_circuit_over_capacity(chain, no_tensor_work):
    verifier = Verifier([Transcript(CHAIN_LABEL)], cap=SMALL_CAP, device="cpu")
    verifier.commit_batch([chain["commitments"]])
    with pytest.raises(ProofError, match="n_pad 32 > cap 16"):
        verifier.verify(chain["circuit"], [chain["proof"]], [chain["commitments"]],
                        _limbs([chain["out"]], (1, 1)))


def test_prover_refuses_a_circuit_over_capacity(chain, no_tensor_work):
    a_L, a_R, a_O = (_limbs(v, (1, CHAIN_GATES)) for v in chain["witness"])
    witness = ProverWitness(a_L=a_L, a_R=a_R, a_O=a_O, v=_limbs([CHAIN_A], (1, 1)),
                            v_blinding=_limbs([CHAIN_BLIND], (1, 1)),
                            publics=_limbs([chain["out"]], (1, 1)))
    prover = Prover([Transcript(CHAIN_LABEL)], cap=SMALL_CAP, device="cpu")
    with pytest.raises(ProofError, match="n_pad 32 > cap 16"):
        prover.prove(chain["circuit"], witness)


def test_prover_refusal_survives_python_O():
    """The refusal is an explicit raise, not an assert that -O strips."""
    script = textwrap.dedent(f"""
        import sys
        assert False, "-O did not strip asserts"
        from dusk_blindbidproof_tpu_torch.models import bulletproofs as bp
        from dusk_blindbidproof_tpu_torch.models import r1cs
        from dusk_blindbidproof_tpu_torch.models.transcript_protocol import ProofError
        from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript
        cs = r1cs.VerifierCS()
        a = cs.commit_var()
        x = r1cs.LC.of(a)
        for _ in range({CHAIN_GATES}):
            x = r1cs.LC.of(cs.multiply(x, r1cs.LC.of(a))[2])
        circuit = bp.CompiledCircuit.compile(cs.artifact(), "cpu")
        bp.generator_tables = lambda cap, device: None
        prover = bp.Prover([Transcript(b"-O")], cap={SMALL_CAP}, device="cpu")
        try:
            prover.prove(circuit, None)
        except ProofError as exc:
            print("refused:", exc)
            sys.exit(0)
        sys.exit(1)
    """)
    proc = subprocess.run([sys.executable, "-O", "-c", script], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "refused: circuit exceeds generator capacity: n_pad 32 > cap 16" in proc.stdout


@pytest.mark.slow
def test_jax_verifier_also_fails_over_capacity(chain):
    """The reference's answer that the port's ProofError stands for: the JAX
    package's Verifier at cap = 16 raises on the same proof too (its server
    answers 0xff to it): a reshape of its unpadded scalars fails."""
    from dusk_blindbidproof_tpu.models.bulletproofs import (
        CompiledCircuit as JaxCircuit,
        Verifier as JaxVerifier,
    )
    from dusk_blindbidproof_tpu.ops import limb as jlimb

    jproof = JaxR1CSProof.from_bytes(chain["proof"].to_bytes())
    verifier = JaxVerifier([JaxTranscript(CHAIN_LABEL)], cap=SMALL_CAP)
    verifier.commit_batch([chain["commitments"]])
    with pytest.raises(TypeError, match="cannot reshape"):
        verifier.verify(JaxCircuit.compile(_chain_artifact(jr1cs)), [jproof],
                        [chain["commitments"]], jlimb.ints_to_limbs_fast([chain["out"]], (1, 1)))
