"""The full-list cell (`bench_cuda/configs/blindbid-L202.json`) against the
benchmark's independent reference, on the CPU.

  * The wide circuit of tests/test_torch_lists.py (m = 48 committed inputs at
    n_pad = cap = 32, K x 20 = 1320 window items a proof: the verifier's
    dynamic MSM takes the bucket path, as at 202 bids) is built again with
    `bench_cuda.reference.circuits.Circuit`.  The port's commitments and proof
    bytes pass `reference.prove.check` from the same witness, blindings and
    32-byte seed, and `reference.verify.verify` gives the port's verdicts on
    the honest proof, t_x + 1, one V_j replaced and one L_j replaced.
  * The configuration's n1, n_pad, m and publics are those of the port's
    `blindbid_circuit(202)` and of the reference's `circuits.blindbid` on a
    202-bid list (synthesis only).
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from test_torch_lists import (  # noqa: E402
    FULL_LIST, WIDE_CASES, WIDE_LABEL, WIDE_M, WIDE_N, mutated, prove_wide, verify_wide,
    wide_inputs,
)

from bench_cuda import traffic  # noqa: E402
from bench_cuda.reference import circuits, prove, verify  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import blindbid as tb  # noqa: E402
from dusk_blindbidproof_tpu_torch.models import r1cs as tr1cs  # noqa: E402

torch.set_num_threads(1)

CONFIG = json.loads((ROOT / "bench_cuda" / "configs" / "blindbid-L202.json").read_text())


def reference_wide(v=None) -> circuits.Circuit:
    """The wide circuit in the reference's builder: gate j multiplies v_{2j}
    by v_{2j+1}; with `v`, its committed values and wires assigned."""
    cs = circuits.Circuit(WIDE_LABEL, assign=v is not None)
    vs = [cs.commit(None if v is None else v[j]) for j in range(WIDE_M)]
    for j in range(WIDE_M // 2):
        cs.multiply(vs[2 * j], vs[2 * j + 1])
    return cs


@pytest.fixture(scope="module")
def wide():
    _artifact, v, blinds, a_L, a_R, a_O = wide_inputs(tr1cs)
    circuit, commitments, proof, seed = prove_wide()
    cases = mutated(proof, commitments)
    port, _scans, _bits = verify_wide(circuit, cases)
    return dict(v=v, blinds=blinds, wires=(a_L, a_R, a_O), commitments=commitments,
                proof=proof, seed=seed, cases=dict(zip(WIDE_CASES, cases)),
                port=dict(zip(WIDE_CASES, port)))


def test_the_reference_builds_the_wide_circuit_with_the_same_witness(wide):
    cs = reference_wide(wide["v"])
    assert (cs.n_gates, cs.n_pad, cs.m) == (WIDE_M // 2, WIDE_N, WIDE_M)
    a_L, a_R, a_O, v = cs.assignment()
    pad = [0] * (WIDE_N - WIDE_M // 2)
    assert (a_L, a_R, a_O) == tuple(list(w) + pad for w in wide["wires"])
    assert v == wide["v"]


def test_the_port_proof_passes_the_reference_prover(wide):
    """Commitments and proof bytes: the reference makes the same proof from
    the witness, the blindings and the seed the port was handed."""
    differ, product = prove.check(reference_wide(wide["v"]), wide["blinds"], wide["seed"],
                                  wide["proof"].to_bytes(), wide["commitments"], WIDE_N,
                                  np.random.default_rng(1))
    assert differ == []
    assert verify.identity_many([lambda: product], WIDE_N, np.random.default_rng(2))


@pytest.mark.parametrize("case", WIDE_CASES)
def test_the_reference_verifier_gives_the_port_verdicts(wide, case):
    proof, commitments = wide["cases"][case]
    ref = verify.verify(reference_wide(), proof.to_bytes(), commitments, WIDE_N)
    assert ref == wide["port"][case] == (case == "honest")


def test_the_full_list_config_is_what_both_syntheses_make():
    assert CONFIG["list_len"] == FULL_LIST == 202
    own = tb.blindbid_circuit(FULL_LIST, torch.device("cpu"))
    assert (own.n1, own.n_pad, own.m, own.n_pub) == (
        CONFIG["n1"], CONFIG["n_pad"], CONFIG["m"], CONFIG["publics"])
    bid = traffic.bidders(7, "full-list", 1, FULL_LIST)[0]
    ref = circuits.blindbid(bid["pub_list"], bid["q"], bid["z_img"], bid["seed"])
    publics = 3 + len(bid["pub_list"])  # q, z_img, the round's seed, the list
    assert (ref.n_gates, ref.n_pad, ref.m, publics) == (
        CONFIG["n1"], CONFIG["n_pad"], CONFIG["m"], CONFIG["publics"])
    # the published capacity's own bound: no padding gate, nothing cut
    assert CONFIG["n1"] == CONFIG["n_pad"] == CONFIG["gens_capacity"]
    assert CONFIG["reduced"] == []
