"""The port's generic R1CS path at other sizes than the BlindBid circuit's.

The circuit is the squaring chain of benchmarks/ipa_bench.py:47-69 (one
committed input v0 = 3, n_pad - 1 gates w_{i+1} = w_i * w_i), proved and
verified through the entry points: `CompiledCircuit.compile`,
`Prover(cap).commit_batch / prove`, `Verifier(cap).commit_batch / verify`.
chip_smoke.py phase 7 runs it on the card at n = cap = 2^10 (against the
frozen vector tests/data/ipa_chain_n1024.hex) and 2^16; here, on the CPU:

  * chip_smoke.chain_inputs gives the circuit and witness that ipa_bench.py's
    own lines build with the JAX package (those lines are run as written);
  * at n_pad = 8, 16, 32, with cap = n_pad and cap = 2 n_pad (the pads of
    `_cap_pad`), the port's proof bytes equal the JAX host oracle's, and the
    port's verdicts equal `host_verify`'s for the honest proof and for t_x + 1,
    ipp_a + 1 and T_3 replaced;
  * phase A's three MSMs, run one after another, give the points of the one
    stacked MSM;
  * slow: the port reproduces the frozen n = 1024 vector, and the JAX host
    oracle makes it.

    JAX_PLATFORMS=cpu python tests/test_torch_ipa_sizes.py   # writes the frozen vector (~70 s)
"""

from __future__ import annotations

import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dusk_blindbidproof_tpu.models import r1cs as jr1cs  # noqa: E402
from dusk_blindbidproof_tpu.models.bulletproofs import (  # noqa: E402
    CompiledCircuit as JaxCompiledCircuit,
)
from dusk_blindbidproof_tpu.models.proof_struct import R1CSProof as JaxR1CSProof  # noqa: E402
from dusk_blindbidproof_tpu.utils import host_oracle as oracle  # noqa: E402
from dusk_blindbidproof_tpu.utils.curve_host import L as JAX_L  # noqa: E402
from dusk_blindbidproof_tpu.utils.merlin import Transcript as JaxTranscript  # noqa: E402

import chip_smoke  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import bulletproofs as bp  # noqa: E402
from dusk_blindbidproof_tpu_torch.ops import limb  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils.curve_host import L  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
IPA_BENCH = ROOT / "benchmarks" / "ipa_bench.py"
# (n_pad, cap): cap = n_pad, and cap = 2 n_pad where the vectors are padded
SIZES = [(8, 8), (8, 16), (16, 16), (16, 32), (32, 32), (32, 64)]
CASES = ("honest", "t_x", "ipp_a", "T_3")


def ipa_bench_chain(n_pad: int):
    """Runs benchmarks/ipa_bench.py's own lines 48-69 (the body of its loop
    over sizes: the circuit, then the witness) with the JAX package's names.
    Returns (artifact, aL, aR, aO, w0)."""
    lines = IPA_BENCH.read_text().splitlines()[47:69]
    assert lines[0].strip().startswith("# chain circuit"), lines[0]
    assert lines[-1].strip() == "aO.append(x)", lines[-1]
    ns = dict(VerifierCS=jr1cs.VerifierCS, LC=jr1cs.LC, CompiledCircuit=JaxCompiledCircuit,
              L=JAX_L, n_pad=n_pad)
    exec(compile(textwrap.dedent("\n".join(lines)), str(IPA_BENCH), "exec"), ns)
    return ns["cs"].artifact(), ns["aL"], ns["aR"], ns["aO"], ns["w0"]


def jax_chain_proof(n_pad: int, cap: int):
    """The JAX package's host oracle on ipa_bench.py's circuit, with the
    transcript label, blinding and seed bytes of chip_smoke.py phase 7:
    (proof, commitments)."""
    artifact, aL, aR, aO, w0 = ipa_bench_chain(n_pad)
    seed = np.random.default_rng(chip_smoke.CHAIN_SEED).bytes(32)
    proof, trace = oracle.host_prove(
        artifact, JaxTranscript(chip_smoke.CHAIN_LABEL), [w0], [chip_smoke.CHAIN_BLIND],
        aL, aR, aO, [], cap, seed=seed)
    return proof, trace.commitments


def port_chain(n_pad: int, cap: int):
    """The port on the CPU through chip_smoke.py phase 7's calls, B = 1:
    (circuit, commitments, proofs)."""
    artifact, *wit = chip_smoke.chain_inputs(n_pad)
    circuit = bp.CompiledCircuit.compile(artifact, CPU)
    commitments, proofs = chip_smoke.chain_prove(
        circuit, chip_smoke.chain_witness(n_pad, 1, *wit), cap, CPU)
    return circuit, commitments, proofs


def mutations(proof) -> list:
    """The proofs of CASES, in order."""
    t_3 = bp.R1CSProof.from_bytes(proof.to_bytes())
    t_3.T_3 = proof.T_4
    return [proof, chip_smoke.bumped(proof, "t_x"), chip_smoke.bumped(proof, "ipp_a"), t_3]


def test_phase7_builder_matches_ipa_bench():
    """chip_smoke.chain_inputs (the port's r1cs) gives at n = 16 the circuit
    and witness that ipa_bench.py's lines give with the JAX package, and
    phase 7 proves with ipa_bench.py's label and blinding."""
    want_art, aL, aR, aO, w0 = ipa_bench_chain(16)
    art, a_L, a_R, a_O = chip_smoke.chain_inputs(16)
    assert (a_L, a_R, a_O, chip_smoke.CHAIN_V0) == (aL, aR, aO, w0)
    for name in ("n_gates", "n_constraints", "n_committed", "n_public"):
        assert getattr(art, name) == getattr(want_art, name), name
    assert art.padded_n() == want_art.padded_n() == 16
    got = {int(k): v for k, v in art.entries.items()}
    want = {int(k): v for k, v in want_art.entries.items()}
    assert got.keys() == want.keys()
    for kind, (qs, idxs, coeffs) in want.items():
        g_qs, g_idxs, g_coeffs = got[kind]
        assert list(g_qs) == list(qs) and list(g_idxs) == list(idxs), kind
        assert [c % L for c in g_coeffs] == [c % JAX_L for c in coeffs], kind
    src = IPA_BENCH.read_text()
    assert f'Transcript(b"{chip_smoke.CHAIN_LABEL.decode()}")' in src
    assert f"blinds = [[{chip_smoke.CHAIN_BLIND}]] * B" in src


@pytest.fixture(scope="module", params=SIZES, ids=[f"n{n}-cap{c}" for n, c in SIZES])
def sized(request):
    n_pad, cap = request.param
    circuit, commitments, proofs = port_chain(n_pad, cap)
    want, want_commitments = jax_chain_proof(n_pad, cap)
    cases = mutations(proofs[0])
    port = chip_smoke.chain_verify(circuit, commitments * len(cases), cases, cap, CPU)
    artifact = ipa_bench_chain(n_pad)[0]
    host = [oracle.host_verify(artifact, JaxTranscript(chip_smoke.CHAIN_LABEL),
                               JaxR1CSProof.from_bytes(p.to_bytes()), want_commitments, [], cap)
            for p in cases]
    return dict(n_pad=n_pad, circuit=circuit, commitments=commitments, proof=proofs[0],
                want=want, want_commitments=want_commitments,
                port=dict(zip(CASES, port)), host=dict(zip(CASES, host)))


def test_proof_bytes_equal_host_oracle(sized):
    assert sized["circuit"].n_pad == sized["n_pad"]
    assert sized["commitments"] == [sized["want_commitments"]]
    assert sized["proof"].to_bytes() == sized["want"].to_bytes()


@pytest.mark.parametrize("case", CASES)
def test_verdicts_equal_host_verify(sized, case):
    assert sized["port"][case] == sized["host"][case] == (case == "honest")


def test_phase_a_equals_one_stacked_msm():
    """phase_a's three MSMs one after another give, limb for limb, what one
    stacked [B, 3, 2cap+2] MSM gives (how phase_a ran before the split), at
    cap = 16 with n_pad = 8 (the pads included) and B = 2."""
    cap, n_pad, B = 16, 8, 2
    gen = np.random.default_rng(9)

    def scalars(*shape):
        vals = [int.from_bytes(gen.bytes(32), "little") % L for _ in range(int(np.prod(shape)))]
        return torch.from_numpy(limb.ints_to_limbs_fast(vals, shape))

    tables = bp.generator_tables(cap, CPU)
    a_L, a_R, a_O, s_L, s_R = (scalars(B, n_pad) for _ in range(5))
    blinds = scalars(B, 3)
    zpad = torch.zeros((B, cap - n_pad, limb.NLIMBS), dtype=torch.int32)
    zero1 = torch.zeros((B, 1, limb.NLIMBS), dtype=torch.int32)
    stacked = torch.stack(
        [torch.cat([g, zpad, h, zpad, zero1, blinds[:, k, None]], dim=1)
         for k, (g, h) in enumerate(((a_L, a_R), (a_O, torch.zeros_like(a_L)), (s_L, s_R)))],
        dim=1)
    want = bp.commit_vectors(tables, stacked)
    got = bp.phase_a(tables, a_L, a_R, a_O, s_L, s_R, blinds)
    assert got.shape == (B, 3, 4, limb.NLIMBS)
    assert torch.equal(got, want)


@pytest.mark.slow
def test_port_reproduces_frozen_n1024_vector():
    """chip_smoke.py phase 7a on the CPU (minutes: the tables of 2050 points
    and the proof run the plain versions)."""
    n = chip_smoke.CHAIN_SMALL
    circuit, commitments, proofs = port_chain(n, n)
    assert proofs[0].to_bytes().hex() == chip_smoke.FROZEN_CHAIN.read_text().strip()
    oks = chip_smoke.chain_verify(circuit, commitments * 2,
                                  [proofs[0], chip_smoke.bumped(proofs[0], "t_x")], n, CPU)
    assert oks == [True, False]


@pytest.mark.slow
def test_jax_oracle_makes_frozen_n1024_vector():
    proof, _ = jax_chain_proof(chip_smoke.CHAIN_SMALL, chip_smoke.CHAIN_SMALL)
    assert proof.to_bytes().hex() == chip_smoke.FROZEN_CHAIN.read_text().strip()


if __name__ == "__main__":
    proof, _ = jax_chain_proof(chip_smoke.CHAIN_SMALL, chip_smoke.CHAIN_SMALL)
    chip_smoke.FROZEN_CHAIN.write_text(proof.to_bytes().hex() + "\n")
    print(f"wrote {chip_smoke.FROZEN_CHAIN} ({len(proof.to_bytes())} bytes)")
