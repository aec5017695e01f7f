"""The port's BlindBid layer against the JAX package's.

Tier 1: the circuit shape and the witness equal the JAX package's, and the
port's circuit arrays equal the JAX package's COO arrays.  Slow: the frozen
n = 2048 proof (tests/data/blindbid_L4_seed42.hex, made once by the JAX
package on the CPU with `prove_batch([req], rng=default_rng(42))`) is
reproduced by both packages, and the port's verifier accepts it.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu.models import blindbid as jb
from dusk_blindbidproof_tpu_torch.models import blindbid as tb
from dusk_blindbidproof_tpu_torch.models import bulletproofs as bp
from dusk_blindbidproof_tpu_torch.models.bulletproofs import CompiledCircuit
from dusk_blindbidproof_tpu_torch.models import gadgets
from dusk_blindbidproof_tpu_torch.models.constants import GENS_CAPACITY
from dusk_blindbidproof_tpu_torch.models.proof_struct import BlindBidProof, R1CSProof
from dusk_blindbidproof_tpu_torch.models.transcript_protocol import (
    IDENTITY_COMPRESSED,
    ProofError,
)
from dusk_blindbidproof_tpu_torch.utils import curve_host as chost

# small tensors: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

FROZEN = Path(__file__).parent / "data" / "blindbid_L4_seed42.hex"
CPU = torch.device("cpu")


def _req(mod, list_len=4, toggle=2):
    return mod.make_prove_request(
        d=123456789, k=987654321, seed=55555,
        pub_list_extra=[1000 + i for i in range(list_len - 1)], toggle_pos=toggle,
    )


def test_circuit_shape_matches_jax():
    c = tb.blindbid_circuit(4, CPU)
    assert (c.n1, c.n_pad, c.m, c.n_pub) == (1454, 2048, 8, 7)
    j = jb.blindbid_circuit(4)
    assert (c.n1, c.n_pad, c.m, c.q, c.n_pub) == (j.n1, j.n_pad, j.m, j.q, j.n_pub)


def test_circuit_arrays_match_jax():
    """CompiledCircuit.from_artifact_arrays on the JAX package's COO arrays
    gives the port's own compiled circuit."""
    j = jb.blindbid_circuit(4)
    coo = {int(k): None if v is None else tuple(np.asarray(a) for a in v)
           for k, v in j.coo.items()}
    c = CompiledCircuit.from_artifact_arrays(j.n1, j.q, j.m, j.n_pub, coo, CPU)
    own = tb.blindbid_circuit(4, CPU)
    assert (c.n_pad, c.n1, c.m, c.q, c.n_pub) == (own.n_pad, own.n1, own.m, own.q, own.n_pub)
    assert c.committed == own.committed
    for kind, entry in own.coo.items():
        if entry is None:
            assert c.coo[kind] is None
            continue
        for a, b in zip(c.coo[kind], entry):
            assert torch.equal(a, b)


def test_witness_and_request_match_jax():
    for toggle in (0, 2, 3):
        rj, rt = _req(jb, toggle=toggle), _req(tb, toggle=toggle)
        assert vars(rj) == vars(rt)
        assert jb.blindbid_witness(rj) == tb.blindbid_witness(rt)


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError):
        tb.prove_batch([_req(tb)])
    with pytest.raises(RuntimeError):
        tb.verify_batch([])


# 203 bids: n1 = 1442 + 3 * 203 = 2051 gates, n_pad = 4096 > GENS_CAPACITY
OVER_CAPACITY_BIDS = 203


def _basepoint_proof(n_bids: int, rounds: int) -> BlindBidProof:
    """A well-formed proof of `rounds` IPA rounds whose points are all the
    Ristretto basepoint's encoding."""
    bp_enc = chost.ristretto_compress(chost.RISTRETTO_BASEPOINT)
    pts = {k: bp_enc for k in ("A_I1", "A_O1", "S1", "T_1", "T_3", "T_4", "T_5", "T_6")}
    r1cs = R1CSProof(**pts, A_I2=IDENTITY_COMPRESSED, A_O2=IDENTITY_COMPRESSED,
                     S2=IDENTITY_COMPRESSED, t_x=1, t_x_blinding=2, e_blinding=3,
                     ipp_L=[bp_enc] * rounds, ipp_R=[bp_enc] * rounds, ipp_a=4, ipp_b=5)
    return BlindBidProof(r1cs=r1cs, commitments=[bp_enc] * 4, t_c=[bp_enc] * n_bids)


@pytest.fixture
def no_tables(monkeypatch):
    """Building the generator tables fails the test."""
    def untouched(cap, device):
        raise AssertionError("generator tables built for a refused request")

    monkeypatch.setattr(bp, "generator_tables", untouched)


@pytest.fixture
def no_synthesis(monkeypatch):
    """Synthesizing a circuit fails the test."""
    def untouched(list_len, device="cpu"):
        raise AssertionError(f"the circuit of {list_len} bids synthesized for a refused request")

    monkeypatch.setattr(tb, "blindbid_circuit", untouched)


def test_circuit_over_capacity():
    c = tb.blindbid_circuit(OVER_CAPACITY_BIDS, CPU)
    assert (c.n1, c.n_pad) == (2051, 4096) and c.n_pad > GENS_CAPACITY
    assert tb.blindbid_circuit(OVER_CAPACITY_BIDS - 1, CPU).n_pad == GENS_CAPACITY


def test_verify_batch_refuses_over_capacity(no_tables, no_synthesis):
    req = tb.VerifyRequest(proof=_basepoint_proof(OVER_CAPACITY_BIDS, 12), score=7,
                           z_img=8, seed=9, pub_list=list(range(OVER_CAPACITY_BIDS)))
    with pytest.raises(ProofError, match="n_pad 4096 > cap 2048"):
        tb.verify_batch([req, req], device="cpu")


def test_prove_batch_refuses_over_capacity(no_tables, no_synthesis):
    reqs = [_req(tb, list_len=OVER_CAPACITY_BIDS, toggle=t) for t in (0, 202)]
    with pytest.raises(ProofError, match="n_pad 4096 > cap 2048"):
        tb.prove_batch(reqs, rng=np.random.default_rng(0), device="cpu")


# list lengths whose circuits the suite synthesizes: the smallest, the main
# path's, the last on the verifier's bit path and the first on its bucket
# path (tests/test_torch_lists.py), the longest list the generators hold and
# the shortest they do not
@pytest.mark.parametrize("list_len", [1, 4, 17, 18, 202, OVER_CAPACITY_BIDS])
def test_shape_from_the_length_matches_synthesis(list_len):
    c = tb.blindbid_circuit(list_len, CPU)
    assert gadgets.blindbid_gates(list_len) == c.n1 == 1442 + 3 * list_len
    assert gadgets.blindbid_n_pad(list_len) == c.n_pad


def test_shape_from_the_length_refuses_an_empty_list():
    with pytest.raises(ValueError, match="empty bid list"):
        gadgets.blindbid_gates(0)
    with pytest.raises(ValueError, match="empty bid list"):
        gadgets.blindbid_n_pad(0)


# 20,000 bids: n1 = 1442 + 3 * 20000 = 61442 gates, n_pad = 65536; its circuit
# would take minutes to synthesize
LONG_LIST_BIDS = 20000


def _call_entry(entry: str, n_bids: int) -> None:
    """The entry point on a batch of two requests of `n_bids` bids."""
    if entry == "verify":
        req = tb.VerifyRequest(proof=_basepoint_proof(n_bids, 16), score=7, z_img=8, seed=9,
                               pub_list=list(range(n_bids)))
        tb.verify_batch([req, req], device="cpu")
    else:
        if n_bids:
            reqs = [_req(tb, list_len=n_bids, toggle=t) for t in (0, n_bids - 1)]
        else:
            reqs = [dataclasses.replace(_req(tb), pub_list=[], toggle=0)] * 2
        tb.prove_batch(reqs, rng=np.random.default_rng(0), device="cpu")


@pytest.mark.parametrize("n_bids, error, match", [
    (LONG_LIST_BIDS, ProofError, "n_pad 65536 > cap 2048"),
    (0, ValueError, "empty bid list"),
])
@pytest.mark.parametrize("entry", ["prove", "verify"])
def test_entry_points_refuse_from_the_length(no_tables, no_synthesis, entry, n_bids,
                                             error, match):
    """Refused from the list's length alone: no circuit is synthesized and no
    table built, whatever the length."""
    with pytest.raises(error, match=match):
        _call_entry(entry, n_bids)
    with pytest.raises(error, match=match):
        tb.check_list_len(n_bids)


@pytest.mark.slow
def test_frozen_full_size_proof():
    frozen = bytes.fromhex(FROZEN.read_text().strip())
    jproof = jb.prove_batch([_req(jb)], rng=np.random.default_rng(42))[0]
    assert tb.proof_blob(jproof) == frozen
    req = _req(tb)
    proof = tb.prove_batch([req], rng=np.random.default_rng(42), device="cpu")[0]
    assert tb.proof_blob(proof) == frozen
    parsed = tb.proof_from_blob(frozen, len(req.pub_list))
    vreq = tb.VerifyRequest(proof=parsed, score=req.q, z_img=req.z_img,
                            seed=req.seed, pub_list=req.pub_list)
    assert tb.verify_batch([vreq], device="cpu") == [True]
    vreq.seed += 1
    assert tb.verify_batch([vreq], device="cpu") == [False]
