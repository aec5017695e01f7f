"""Faults planted underneath the timed path, to show that `correct` fails.

The benchmark's own runs plant none.  The control and fault runs
(`run.py --fault <name>`) plant one before the window opens, in the process
that runs the passes:

  accept_all   the control: the verifier answers True for every proof, so the
               guarantee that an altered proof is refused is broken;
  alter_proof  an answer altered where it is produced: every proof the
               prover returns has t_x plus one;
  drop_half    half of the batch left out: the prover returns the first
               half of its proofs only;
  fixed_blinding  the blinding draws come from one fixed generator instead of
               the rng forked from each proof's transcript, its blindings and
               the seed: every proof still verifies, and its bytes no longer
               follow from the inputs the configuration says they do.
"""

from __future__ import annotations

FAULTS = ("accept_all", "alter_proof", "drop_half", "fixed_blinding")


def install(name: str | None) -> None:
    if name is None:
        return
    if name not in FAULTS:
        raise SystemExit(f"unknown fault {name!r}; known: {FAULTS}")
    from dusk_blindbidproof_tpu_torch.models import bulletproofs

    from .reference.curve import L

    prove, verify = bulletproofs.Prover.prove, bulletproofs.Verifier.verify

    if name == "accept_all":
        def verify_all(self, circuit, proofs, *args, **kwargs):
            verify(self, circuit, proofs, *args, **kwargs)
            return [True] * len(proofs)
        bulletproofs.Verifier.verify = verify_all
    elif name == "alter_proof":
        def prove_altered(self, *args, **kwargs):
            proofs = prove(self, *args, **kwargs)
            for p in proofs:
                p.t_x = (p.t_x + 1) % L
            return proofs
        bulletproofs.Prover.prove = prove_altered
    elif name == "drop_half":
        def prove_half(self, *args, **kwargs):
            proofs = prove(self, *args, **kwargs)
            return proofs[:len(proofs) // 2]
        bulletproofs.Prover.prove = prove_half
    else:
        import numpy as np

        fixed = np.random.default_rng(0)
        sample, sample_int = bulletproofs._sample_scalar_limbs, bulletproofs._sample_int
        bulletproofs._sample_scalar_limbs = lambda rng, shape: sample(fixed, shape)
        bulletproofs._sample_int = lambda rng: sample_int(fixed)
