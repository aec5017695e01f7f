"""The witness wires in their two forms, on the CPU.

The prover takes a_L, a_R and a_O as [B, n_pad, 8] little-endian int32 words
(the values' bytes, made limbs on its device by `limb.limbs_from_words`) or
as [B, n_pad, NLIMBS] limbs.  The same witness in either form, or in both
mixed, gives byte-identical proofs; any other trailing dimension is refused
before any copy.  `blindbid.witness_words`, the packing `prove_batch` sends,
gives the limbs of `blindbid_witness`'s wires on the device, zero past the
gates and in the rows a mesh rank does not prove.
"""

import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu_torch.models import blindbid
from dusk_blindbidproof_tpu_torch.models import bulletproofs as bp
from dusk_blindbidproof_tpu_torch.models import r1cs
from dusk_blindbidproof_tpu_torch.models.gadgets import blindbid_n_pad
from dusk_blindbidproof_tpu_torch.ops import limb
from dusk_blindbidproof_tpu_torch.utils.curve_host import L
from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript

# small tensors: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

CAP = 32
GATES = 20
LABEL = b"torch-port-words"
A_VALS = (987654321, 2**251 + 12345)  # one small value, one of full width
BLINDS = (4242, 31337)


def _chain_circuit():
    """x_{i+1} = x_i * a over GATES gates, public x_GATES."""
    cs = r1cs.VerifierCS()
    a = cs.commit_var()
    pub = cs.public_var()
    x = r1cs.LC.of(a)
    for _ in range(GATES):
        _, _, o = cs.multiply(x, r1cs.LC.of(a))
        x = r1cs.LC.of(o)
    cs.constrain(x - pub)
    return bp.CompiledCircuit.compile(cs.artifact(), "cpu")


def _chain_wires(a: int):
    a_L, a_R, a_O = [], [], []
    x = a
    for _ in range(GATES):
        a_L.append(x)
        a_R.append(a)
        x = x * a % L
        a_O.append(x)
    return (a_L, a_R, a_O), x


@pytest.fixture(scope="module")
def chain():
    circuit = _chain_circuit()
    wires, outs = zip(*(_chain_wires(a) for a in A_VALS))
    return dict(circuit=circuit, wires=wires, outs=outs,
                words=blindbid.witness_words(wires, range(len(A_VALS)), len(A_VALS),
                                             circuit.n_pad))


def _limbs(vals, shape):
    return limb.ints_to_limbs_fast(vals, shape)


def _as_limbs(words):
    return limb.limbs_from_words(torch.from_numpy(np.ascontiguousarray(words))).numpy()


def _prove(chain, a_L, a_R, a_O):
    B = len(A_VALS)
    prover = bp.Prover([Transcript(LABEL) for _ in range(B)], cap=CAP, device="cpu")
    prover.commit_batch([[a] for a in A_VALS], [[b] for b in BLINDS])
    witness = bp.ProverWitness(
        a_L=a_L, a_R=a_R, a_O=a_O, v=_limbs(A_VALS, (B, 1)),
        v_blinding=_limbs(BLINDS, (B, 1)), publics=_limbs(chain["outs"], (B, 1)))
    return [p.to_bytes() for p in prover.prove(chain["circuit"], witness, seed=b"\x07" * 32)]


@pytest.mark.parametrize("form", ["words", "a_L_words"])
def test_words_and_limbs_give_the_same_proofs(chain, form):
    words = chain["words"]
    limbs = [_as_limbs(w) for w in words]
    want = _prove(chain, *limbs)
    given = list(words) if form == "words" else [words[0], limbs[1], limbs[2]]
    got = _prove(chain, *given)
    assert len(got) == len(A_VALS) and got == want
    assert got[0] != got[1]


@pytest.mark.parametrize("wire", ["a_L", "a_R", "a_O"])
@pytest.mark.parametrize("last", [32, limb.NLIMBS - 1])
def test_other_trailing_dimensions_are_refused_before_any_copy(chain, monkeypatch,
                                                               wire, last):
    def untouched(*args, **kwargs):
        raise AssertionError("a copy to the device before the form check")

    B, n_pad = len(A_VALS), chain["circuit"].n_pad
    forms = {w: np.asarray(x) for w, x in zip(("a_L", "a_R", "a_O"), chain["words"])}
    forms[wire] = np.zeros((B, n_pad, last), dtype=np.int32)
    witness = bp.ProverWitness(**forms, v=_limbs(A_VALS, (B, 1)),
                               v_blinding=_limbs(BLINDS, (B, 1)),
                               publics=_limbs(chain["outs"], (B, 1)))
    prover = bp.Prover([Transcript(LABEL) for _ in range(B)], cap=CAP, device="cpu")
    monkeypatch.setattr(bp, "_dev", untouched)
    with pytest.raises(ValueError, match=f"{wire}: trailing dimension {last}"):
        prover.prove(chain["circuit"], witness)


@pytest.fixture(scope="module")
def blindbid_wires():
    reqs = [blindbid.make_prove_request(d=1000 + i, k=2000 + i, seed=3000 + i,
                                        pub_list_extra=[11, 12, 13], toggle_pos=i)
            for i in range(2)]
    return [blindbid.blindbid_witness(r) for r in reqs]


@pytest.mark.parametrize("rows", [range(0, 2), range(1, 2), range(0, 1)],
                         ids=["whole_batch", "rank_row_1", "rank_row_0"])
def test_witness_words_are_the_wires_limbs(blindbid_wires, rows):
    B, n_pad = 2, blindbid_n_pad(4)
    words = blindbid.witness_words([blindbid_wires[i] for i in rows], rows, B, n_pad)
    assert words.dtype == np.dtype("<i4") and words.shape == (3, B, n_pad, 8)
    got = _as_limbs(words)  # [3, B, n_pad, NLIMBS]
    for i in range(B):
        for w in range(3):
            if i not in rows:
                assert not got[w, i].any()
                continue
            wire = blindbid_wires[i][w]
            n1 = len(wire)
            assert 0 < n1 <= n_pad
            assert (got[w, i, :n1] == limb.ints_to_limbs_fast(wire)).all()
            assert not got[w, i, n1:].any()
