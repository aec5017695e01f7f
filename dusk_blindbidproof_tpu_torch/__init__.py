"""dusk_blindbidproof_tpu_torch — the Bulletproofs R1CS + BlindBid framework
on PyTorch and CUDA, the counterpart of `dusk_blindbidproof_tpu` (JAX).

Layers, from the entry point down:

  * ``server``   — asyncio Unix-domain-socket daemon speaking the opcode-1/2
                   protocol over TLV frames; concurrent requests of one shape
                   become one batched device pass (`BatchingService`).
  * ``models``   — the proof system: R1CS constraint system, gadget library
                   (MiMC, one-of-many, score), Bulletproofs prover/verifier,
                   inner-product argument, the BlindBid circuit and its wire
                   types (`bid`, `proof_struct`).
  * ``ops``      — batched field/scalar/point arithmetic and MSM on int32
                   limb tensors; `ops.fused` binds the hand-written Hopper
                   kernels of ``csrc/`` and keeps their plain versions.
  * ``utils``    — host-side transcript (Keccak/STROBE/Merlin), generator
                   setup, TLV wire codec, the pure-Python proof oracle,
                   profiling spans.

Entry points run on CUDA unless the caller passes ``device=``; nothing here
imports JAX or the JAX package.
"""

__version__ = "0.1.0"
