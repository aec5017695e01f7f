"""Differential debugging of the PyTorch/CUDA port: its tensor prover and
verifier against its pure-Python host oracle (utils/host_oracle.py).

Proves the cube circuit (a^3 = public, a = 12345, blinding 111) both ways on
the same inputs, prints the FIRST intermediate that diverges, then the 2 x 2
verification matrix (each proof by each verifier).  Exits 0 only on "ALL OK".

Usage:
    python scripts/oracle_compare_torch.py [cap]                # on the GPU
    python scripts/oracle_compare_torch.py [cap] --device cpu   # plain versions
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from dusk_blindbidproof_tpu_torch.models.bulletproofs import (  # noqa: E402
    CompiledCircuit,
    Prover,
    ProverWitness,
    Verifier,
)
from dusk_blindbidproof_tpu_torch.models.r1cs import LC, VerifierCS  # noqa: E402
from dusk_blindbidproof_tpu_torch.ops import limb  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils import host_oracle as oracle  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils.curve_host import L  # noqa: E402
from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript  # noqa: E402

LABEL = b"tiny-cube-proof"
A_VAL, BLIND = 12345, 111


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cap", nargs="?", type=int, default=8, help="generator capacity")
    ap.add_argument("--device", default=None,
                    help="torch device of the tensor prover (default: cuda; raises without a GPU)")
    args = ap.parse_args(argv)
    cap = args.cap
    prover = Prover([Transcript(LABEL)], cap=cap, device=args.device)
    print("device:", prover.device)

    cs = VerifierCS()
    a = cs.commit_var()
    pub = cs.public_var()
    _, _, o = cs.multiply(LC.of(a), LC.of(a))
    _, _, o2 = cs.multiply(LC.of(o), LC.of(a))
    cs.constrain(LC.of(o2) - pub)
    artifact = cs.artifact()

    a2 = A_VAL * A_VAL % L
    a3 = a2 * A_VAL % L
    a_L, a_R, a_O, publics = [A_VAL, a2], [A_VAL, A_VAL], [a2, a3], [a3]

    # ---- host proof -------------------------------------------------------
    h_proof, htr = oracle.host_prove(artifact, Transcript(LABEL), [A_VAL], [BLIND],
                                     a_L, a_R, a_O, publics, cap)
    h_ok = oracle.host_verify(artifact, Transcript(LABEL), h_proof, htr.commitments,
                              publics, cap)
    print("host proof verifies on host:", h_ok)

    # ---- tensor proof -----------------------------------------------------
    circuit = CompiledCircuit.compile(artifact, prover.device)
    n_pad = circuit.n_pad

    def row(vals):
        arr = np.zeros((1, n_pad, limb.NLIMBS), dtype=np.int32)
        arr[0, : len(vals)] = limb.ints_to_limbs_fast(vals)
        return arr

    witness = ProverWitness(
        a_L=row(a_L), a_R=row(a_R), a_O=row(a_O),
        v=limb.ints_to_limbs_fast([A_VAL], (1, 1)),
        v_blinding=limb.ints_to_limbs_fast([BLIND], (1, 1)),
        publics=limb.ints_to_limbs_fast(publics, (1, 1)),
    )
    commitments = prover.commit_batch([[A_VAL]], [[BLIND]])
    d_proof = prover.prove(circuit, witness)[0]

    # ---- compare intermediates -------------------------------------------
    diverged = False

    def cmp(name, dev, hostv):
        nonlocal diverged
        if dev != hostv and not diverged:
            print(f"FIRST DIVERGENCE at {name}:")
            print("  device:", dev.hex() if isinstance(dev, bytes) else dev)
            print("  host:  ", hostv.hex() if isinstance(hostv, bytes) else hostv)
            diverged = True
        elif dev != hostv:
            print(f"  (also differs: {name})")

    cmp("V commitment", commitments[0][0], htr.commitments[0])
    cmp("A_I1", d_proof.A_I1, htr.A_I1)
    cmp("A_O1", d_proof.A_O1, htr.A_O1)
    cmp("S1", d_proof.S1, htr.S1)
    for k, label in enumerate(("T_1", "T_3", "T_4", "T_5", "T_6")):
        cmp(label, getattr(d_proof, label), htr.T_bytes[k])
    cmp("t_x", d_proof.t_x, htr.t_x)
    cmp("t_x_blinding", d_proof.t_x_blinding, htr.t_x_blinding)
    cmp("e_blinding", d_proof.e_blinding, htr.e_blinding)
    for j, (lb, rb) in enumerate(zip(d_proof.ipp_L, d_proof.ipp_R)):
        cmp(f"L[{j}]", lb, htr.L_bytes[j])
        cmp(f"R[{j}]", rb, htr.R_bytes[j])
    cmp("ipp_a", d_proof.ipp_a, htr.a)
    cmp("ipp_b", d_proof.ipp_b, htr.b)
    if not diverged:
        print("prover intermediates: all equal (device == host oracle)")

    # ---- the 2 x 2 verification matrix -------------------------------------
    hv_dev = oracle.host_verify(artifact, Transcript(LABEL), d_proof, commitments[0],
                                publics, cap)

    def device_verify(proof, comms):
        verifier = Verifier([Transcript(LABEL)], cap=cap, device=prover.device)
        verifier.commit_batch([comms])
        return verifier.verify(circuit, [proof], [comms],
                               limb.ints_to_limbs_fast(publics, (1, 1)))[0]

    dv_dev = device_verify(d_proof, commitments[0])
    dv_host = device_verify(h_proof, htr.commitments)
    print("verification matrix (rows: proof, columns: verifier):")
    print(f"  device proof:  host {hv_dev}  device {dv_dev}")
    print(f"  host proof:    host {h_ok}  device {dv_host}")

    ok = h_ok and hv_dev and dv_dev and dv_host and not diverged
    print("RESULT:", "ALL OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
