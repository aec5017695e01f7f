"""BlindBid at list lengths other than 4, and the verifier's dynamic MSM on
its bucket path.

The verifier's dynamic MSM takes K = m + 5 + 3 + 2 log2(n_pad) points a
proof: the m commitments, T_1,3,4,5,6, A_I1 A_O1 S1 and the IPA's L_j R_j
(the phase-2 points are the identity and are left out).  `msm.msm` scales
each to WINDOWS = 20 window items; up to `msm.BIT_MSM_MAX_ITEMS` = 1024
items the MSM takes the bit-plane path, above it the bucket path, whose leaf
scan is `fused.add_scan` over extended points.  BlindBid with L bids has
m = 4 + L and 11 rounds, so K = L + 34: lists of up to 17 bids take the bit
path, lists of 18 or more the bucket path.  L = 202 is the longest list the
generators hold: n1 = 1442 + 3 x 202 = 2048 = n_pad, no padding gate.

Tier 1, on the CPU with the plain versions, exact (canonical values and
bytes equal):
  * at L = 1, 14, 15, 17, 18 and 202 the port's `blindbid_circuit` (shape
    and arrays) and `blindbid_witness` equal the JAX package's;
  * a generic R1CS circuit built with the port's models/r1cs.py, as
    chip_smoke.chain_inputs builds its own, with m = 48 committed inputs at
    n_pad = cap = 32 (K = 66 points, 1320 items): the port's proof bytes
    equal the JAX host oracle's, its verdicts equal `host_verify`'s for the
    honest proof, t_x + 1, one V_j replaced and one L_j replaced, and its
    verifier's dynamic MSM took the bucket branch.
Slow: the port reproduces tests/data/blindbid_L202_seed42.hex on the CPU,
accepts it and rejects it with a wrong seed; the JAX package makes it.

The frozen vector was made once by the JAX package on the CPU (its
`prove_batch`, not the host oracle) with `prove_batch([req],
rng=default_rng(42))`, req = `make_prove_request(d=123456789, k=987654321,
seed=55555, pub_list_extra=[1000 + i for i in range(201)], toggle_pos=101)`
(the prover's own bid at place 101 of 202), in the `proof_blob` layout:

    JAX_PLATFORMS=cpu python tests/test_torch_lists.py   # rewrites it (~16 min)
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

from dusk_blindbidproof_tpu.models import blindbid as jb  # noqa: E402
from dusk_blindbidproof_tpu.models import r1cs as jr1cs  # noqa: E402
from dusk_blindbidproof_tpu.models.proof_struct import R1CSProof as JaxR1CSProof  # noqa: E402
from dusk_blindbidproof_tpu.utils import host_oracle as oracle  # noqa: E402
from dusk_blindbidproof_tpu.utils.merlin import Transcript as JaxTranscript  # noqa: E402

import chip_smoke  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import blindbid as tb  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import bulletproofs as bp  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import r1cs as tr1cs  # noqa: E402
from dusk_blindbidproof_tpu_torch.models.bulletproofs import CompiledCircuit  # noqa: E402
from dusk_blindbidproof_tpu_torch.models.constants import GENS_CAPACITY  # noqa: E402
from dusk_blindbidproof_tpu_torch.ops import limb, msm  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils.curve_host import L  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript  # noqa: E402

torch.set_num_threads(1)

CPU = torch.device("cpu")
FROZEN_L202 = ROOT / "tests" / "data" / "blindbid_L202_seed42.hex"
# 1 and 202 are the ends; 17 and 18 sit on either side of the dynamic MSM's
# switch from the bit path to the bucket path; 14 and 15 below it
LIST_LENS = (1, 14, 15, 17, 18, 202)
FULL_LIST = 202
FULL_TOGGLE = 101


def full_list_request(mod):
    """The request of the frozen L = 202 vector, from `mod` (either package's
    models.blindbid)."""
    return mod.make_prove_request(
        d=123456789, k=987654321, seed=55555,
        pub_list_extra=[1000 + i for i in range(FULL_LIST - 1)], toggle_pos=FULL_TOGGLE)


def dynamic_points(m: int, n_pad: int) -> int:
    """K of the verifier's dynamic MSM for a one-phase proof."""
    return m + 5 + 3 + 2 * (n_pad.bit_length() - 1)


# ---------------------------------------------------------------------------
# BlindBid circuit and witness at other list lengths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("list_len", LIST_LENS)
def test_circuit_equals_jax(list_len):
    """Shape (n1, n_pad, m, publics) and the COO arrays: the port's circuit
    equals the one `from_artifact_arrays` makes of the JAX package's."""
    own = tb.blindbid_circuit(list_len, CPU)
    assert (own.n1, own.n_pad, own.m, own.n_pub) == (
        1442 + 3 * list_len, GENS_CAPACITY, 4 + list_len, 3 + list_len)
    j = jb.blindbid_circuit(list_len)
    assert (own.n1, own.n_pad, own.m, own.q, own.n_pub) == (j.n1, j.n_pad, j.m, j.q, j.n_pub)
    coo = {int(k): None if v is None else tuple(np.asarray(a) for a in v)
           for k, v in j.coo.items()}
    c = CompiledCircuit.from_artifact_arrays(j.n1, j.q, j.m, j.n_pub, coo, CPU)
    assert c.committed == own.committed
    for kind, entry in own.coo.items():
        if entry is None:
            assert c.coo[kind] is None
            continue
        for a, b in zip(c.coo[kind], entry):
            assert torch.equal(a, b)
    # the dynamic MSM's path at this length (see the module docstring)
    items = dynamic_points(own.m, own.n_pad) * msm.WINDOWS
    assert (items > msm.BIT_MSM_MAX_ITEMS) == (list_len >= 18)


@pytest.mark.parametrize("list_len", LIST_LENS)
def test_witness_equals_jax(list_len):
    """The witness at the first, an interior and the last place of the
    list, with the request each package derives."""
    for toggle in sorted({0, list_len // 2, list_len - 1}):
        extra = [1000 + 7 * i for i in range(list_len - 1)]
        rj = jb.make_prove_request(d=1234567 + toggle, k=7654321, seed=99 + list_len,
                                   pub_list_extra=extra, toggle_pos=toggle)
        rt = tb.make_prove_request(d=1234567 + toggle, k=7654321, seed=99 + list_len,
                                   pub_list_extra=extra, toggle_pos=toggle)
        assert vars(rj) == vars(rt)
        wj, wt = jb.blindbid_witness(rj), tb.blindbid_witness(rt)
        assert wj == wt
        assert len(wt[0]) == 1442 + 3 * list_len


def test_full_list_request_equals_jax():
    assert vars(full_list_request(jb)) == vars(full_list_request(tb))
    assert full_list_request(tb).pub_list[FULL_TOGGLE] not in range(1000, 1201)


def test_phase8_proves_the_frozen_request():
    """chip_smoke.py phase 8a proves bidder 0 of its full list: the request
    of the frozen vector; its other bidders are lists of 202 too."""
    reqs = chip_smoke.requests(3, chip_smoke.full_list_inputs)
    assert vars(reqs[0]) == vars(full_list_request(tb))
    assert [len(r.pub_list) for r in reqs] == [chip_smoke.FULL_LIST] * 3 == [FULL_LIST] * 3
    assert chip_smoke.FULL_LIST_POINTS == dynamic_points(4 + FULL_LIST, GENS_CAPACITY)


# ---------------------------------------------------------------------------
# A generic circuit whose verifier takes the bucket path
# ---------------------------------------------------------------------------

WIDE_M, WIDE_N = 48, 32  # committed inputs, n_pad = cap
WIDE_LABEL = b"wide-commitments"
WIDE_SEED = 48
WIDE_CASES = ("honest", "t_x", "V_j", "L_j")


def wide_inputs(r1cs_mod):
    """48 committed inputs v_0..v_47 tied to 24 gates by their linear
    constraints: gate j multiplies v_{2j} by v_{2j+1} (n_pad = 32).  Built
    with `r1cs_mod` (the port's or the JAX package's models.r1cs).  Returns
    (artifact, v, blindings, a_L, a_R, a_O) as python ints."""
    gen = np.random.default_rng(WIDE_SEED)
    v = [int.from_bytes(gen.bytes(32), "little") % L for _ in range(WIDE_M)]
    blinds = [int.from_bytes(gen.bytes(32), "little") % L for _ in range(WIDE_M)]
    cs = r1cs_mod.VerifierCS()
    vs = [cs.commit_var() for _ in range(WIDE_M)]
    for j in range(WIDE_M // 2):
        cs.multiply(r1cs_mod.LC.of(vs[2 * j]), r1cs_mod.LC.of(vs[2 * j + 1]))
    a_L, a_R = v[0::2], v[1::2]
    a_O = [a * b % L for a, b in zip(a_L, a_R)]
    return cs.artifact(), v, blinds, a_L, a_R, a_O


def mutated(proof, commitments):
    """(proof, commitments) of WIDE_CASES, in order."""
    t_x = chip_smoke.bumped(proof, "t_x")
    v_j = list(commitments)
    v_j[5] = commitments[6]
    l_j = bp.R1CSProof.from_bytes(proof.to_bytes())
    l_j.ipp_L = list(proof.ipp_L)
    l_j.ipp_L[2] = proof.ipp_R[2]
    return [(proof, commitments), (t_x, commitments), (proof, v_j), (l_j, commitments)]


@pytest.fixture(scope="module")
def wide():
    artifact, v, blinds, a_L, a_R, a_O = wide_inputs(tr1cs)
    circuit = CompiledCircuit.compile(artifact, CPU)
    seed = np.random.default_rng(WIDE_SEED).bytes(32)
    prover = bp.Prover([Transcript(WIDE_LABEL)], cap=WIDE_N, device=CPU)
    commitments = prover.commit_batch([v], [blinds])[0]

    def rows(vals):
        out = np.zeros((1, WIDE_N, limb.NLIMBS), dtype=np.int32)
        out[0, :len(vals)] = limb.ints_to_limbs_fast(vals)
        return out

    witness = bp.ProverWitness(
        a_L=rows(a_L), a_R=rows(a_R), a_O=rows(a_O),
        v=limb.ints_to_limbs_fast(v, (1, WIDE_M)),
        v_blinding=limb.ints_to_limbs_fast(blinds, (1, WIDE_M)),
        publics=np.zeros((1, 0, limb.NLIMBS), dtype=np.int32))
    proof = prover.prove(circuit, witness, seed=seed)[0]

    jart, *jwit = wide_inputs(jr1cs)
    want, trace = oracle.host_prove(jart, JaxTranscript(WIDE_LABEL), *jwit, [], WIDE_N,
                                    seed=seed)
    cases = mutated(proof, commitments)
    host = [oracle.host_verify(jart, JaxTranscript(WIDE_LABEL),
                               JaxR1CSProof.from_bytes(p.to_bytes()), c, [], WIDE_N)
            for p, c in cases]

    # the port's verifier over the four cases as one batch, its MSM branches recorded
    scans, bits = [], []
    bucket_scan_rows, bit_msm = msm._bucket_scan_rows, msm._bit_msm

    def recording_scan(pts_sorted, niels):
        scans.append((niels, tuple(pts_sorted.shape)))
        return bucket_scan_rows(pts_sorted, niels)

    def recording_bits(points, digits):
        bits.append(tuple(points.shape))
        return bit_msm(points, digits)

    verifier = bp.Verifier([Transcript(WIDE_LABEL) for _ in cases], cap=WIDE_N, device=CPU)
    batch = [c for _, c in cases]
    verifier.commit_batch(batch)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(msm, "_bucket_scan_rows", recording_scan)
        mp.setattr(msm, "_bit_msm", recording_bits)
        port = verifier.verify(circuit, [p for p, _ in cases], batch,
                               np.zeros((len(cases), 0, limb.NLIMBS), dtype=np.int32))
    return dict(circuit=circuit, commitments=commitments, proof=proof, want=want,
                want_commitments=trace.commitments, port=dict(zip(WIDE_CASES, port)),
                host=dict(zip(WIDE_CASES, host)), scans=scans, bits=bits)


def test_wide_circuit_shape(wide):
    c = wide["circuit"]
    assert (c.n1, c.n_pad, c.m, c.n_pub) == (WIDE_M // 2, WIDE_N, WIDE_M, 0)
    assert dynamic_points(c.m, c.n_pad) * msm.WINDOWS > msm.BIT_MSM_MAX_ITEMS


def test_wide_proof_bytes_equal_host_oracle(wide):
    assert wide["commitments"] == wide["want_commitments"]
    assert wide["proof"].to_bytes() == wide["want"].to_bytes()
    assert wide["proof"].missing_phase2()


@pytest.mark.parametrize("case", WIDE_CASES)
def test_wide_verdicts_equal_host_verify(wide, case):
    assert wide["port"][case] == wide["host"][case] == (case == "honest")


def test_wide_verifier_takes_bucket_path(wide):
    """The dynamic MSM (extended points, niels=False) went through the
    bucket scan with K x WINDOWS items a proof; the bit path never ran."""
    K = dynamic_points(WIDE_M, WIDE_N)
    assert (False, (len(WIDE_CASES), K * msm.WINDOWS, 4, limb.NLIMBS)) in wide["scans"]
    assert wide["bits"] == []
    assert any(niels for niels, _ in wide["scans"])  # and the fixed-base MSM, as always


# ---------------------------------------------------------------------------
# The frozen L = 202 vector
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_port_reproduces_frozen_full_list():
    """The port on the CPU (minutes: n = 2048, the plain versions)."""
    frozen = FROZEN_L202.read_text().strip()
    req = full_list_request(tb)
    proof = tb.prove_batch([req], rng=np.random.default_rng(42), device="cpu")[0]
    assert (len(proof.commitments), len(proof.t_c)) == (4, FULL_LIST)
    assert tb.proof_blob(proof).hex() == frozen
    parsed = tb.proof_from_blob(bytes.fromhex(frozen), FULL_LIST)
    vreq = tb.VerifyRequest(proof=parsed, score=req.q, z_img=req.z_img, seed=req.seed,
                            pub_list=req.pub_list)
    wrong = tb.VerifyRequest(proof=parsed, score=req.q, z_img=req.z_img, seed=req.seed + 1,
                             pub_list=req.pub_list)
    assert tb.verify_batch([vreq, wrong], device="cpu") == [True, False]


def jax_full_list_blob() -> bytes:
    proof = jb.prove_batch([full_list_request(jb)], rng=np.random.default_rng(42))[0]
    return b"".join(proof.commitments) + b"".join(proof.t_c) + proof.r1cs.to_bytes()


@pytest.mark.slow
def test_jax_package_makes_frozen_full_list():
    assert jax_full_list_blob().hex() == FROZEN_L202.read_text().strip()


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    blob = jax_full_list_blob()
    FROZEN_L202.write_text(blob.hex() + "\n")
    print(f"wrote {FROZEN_L202} ({len(blob)} bytes)")
