"""The witness wires in their two forms, on the CPU.

The prover takes a_L, a_R and a_O from the host as [B, n_pad, NLIMBS] limbs,
or as limb tensors already on its device (`prove_batch` makes them there),
which it uses with no copy; publics and v may be such tensors too.  The same
witness in either form, or in forms mixed, gives byte-identical proofs.  A
host wire of any other trailing dimension (the values' 32 bytes as 8
little-endian int32 words among them), a tensor on another device than the
prover's or of another row count, and a v_blinding tensor (it is read on the
host) are refused before any copy.
"""

import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu_torch.models import bulletproofs as bp
from dusk_blindbidproof_tpu_torch.models import r1cs
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
                words=_words(wires, circuit.n_pad))


def _words(wires, n_pad: int) -> np.ndarray:
    """[3, B, n_pad, 8] little-endian int32 words of the rows' wires."""
    buf = np.zeros((3, len(wires), n_pad, 32), dtype=np.uint8)
    for i, row in enumerate(wires):
        for w, wire in enumerate(row):
            buf[w, i, :len(wire)] = np.frombuffer(
                b"".join(v.to_bytes(32, "little") for v in wire), np.uint8).reshape(-1, 32)
    return buf.view("<i4")


def _limbs(vals, shape):
    return limb.ints_to_limbs_fast(vals, shape)


def _as_limbs(words):
    return limb.limbs_from_words(torch.from_numpy(np.ascontiguousarray(words))).numpy()


def _prove(chain, a_L, a_R, a_O, publics=None):
    B = len(A_VALS)
    prover = bp.Prover([Transcript(LABEL) for _ in range(B)], cap=CAP, device="cpu")
    prover.commit_batch([[a] for a in A_VALS], [[b] for b in BLINDS])
    witness = bp.ProverWitness(
        a_L=a_L, a_R=a_R, a_O=a_O, v=_limbs(A_VALS, (B, 1)),
        v_blinding=_limbs(BLINDS, (B, 1)),
        publics=_limbs(chain["outs"], (B, 1)) if publics is None else publics)
    return [p.to_bytes() for p in prover.prove(chain["circuit"], witness, seed=b"\x07" * 32)]


@pytest.fixture(scope="module")
def want(chain):
    """The proofs of the witness given as host limbs."""
    return _prove(chain, *(_as_limbs(w) for w in chain["words"]))


@pytest.mark.parametrize("form", ["words", "a_L_words"])
def test_words_and_limbs_give_the_same_proofs(chain, want, form, monkeypatch):
    """The values' words made limbs on the host prove, host limbs and device
    limbs mixed, what the host limbs prove; the words themselves, all three
    wires or a_L alone, are refused before any copy."""
    words = chain["words"]
    limbs = [_as_limbs(w) for w in words]
    tensors = [torch.from_numpy(x) for x in limbs]
    mixed = [limbs[0], tensors[1], tensors[2]] if form == "words" else \
        [tensors[0], limbs[1], limbs[2]]
    got = _prove(chain, *mixed)
    assert len(got) == len(A_VALS) and got == want
    assert got[0] != got[1]

    def untouched(*args, **kwargs):
        raise AssertionError("a copy to the device before the form check")

    B = len(A_VALS)
    given = list(words) if form == "words" else [words[0], limbs[1], limbs[2]]
    witness = bp.ProverWitness(*given, v=_limbs(A_VALS, (B, 1)),
                               v_blinding=_limbs(BLINDS, (B, 1)),
                               publics=_limbs(chain["outs"], (B, 1)))
    prover = bp.Prover([Transcript(LABEL) for _ in range(B)], cap=CAP, device="cpu")
    monkeypatch.setattr(bp, "_dev", untouched)
    with pytest.raises(ValueError, match="a_L: trailing dimension 8"):
        prover.prove(chain["circuit"], witness)


@pytest.mark.parametrize("wire", ["a_L", "a_R", "a_O"])
@pytest.mark.parametrize("last", [32, limb.NLIMBS - 1, 8])
def test_other_trailing_dimensions_are_refused_before_any_copy(chain, monkeypatch,
                                                               wire, last):
    def untouched(*args, **kwargs):
        raise AssertionError("a copy to the device before the form check")

    B, n_pad = len(A_VALS), chain["circuit"].n_pad
    forms = {w: _as_limbs(x) for w, x in zip(("a_L", "a_R", "a_O"), chain["words"])}
    forms[wire] = np.zeros((B, n_pad, last), dtype=np.int32)
    witness = bp.ProverWitness(**forms, v=_limbs(A_VALS, (B, 1)),
                               v_blinding=_limbs(BLINDS, (B, 1)),
                               publics=_limbs(chain["outs"], (B, 1)))
    prover = bp.Prover([Transcript(LABEL) for _ in range(B)], cap=CAP, device="cpu")
    monkeypatch.setattr(bp, "_dev", untouched)
    with pytest.raises(ValueError, match=f"{wire}: trailing dimension {last}"):
        prover.prove(chain["circuit"], witness)


def test_tensors_on_the_prover_device_give_the_same_proofs(chain, want):
    """Limb tensors on the prover's device (here the CPU), the wires and the
    publics, are used as they are and prove what the host limbs prove."""
    tensors = [torch.from_numpy(_as_limbs(w)) for w in chain["words"]]
    publics = torch.from_numpy(_limbs(chain["outs"], (len(A_VALS), 1)))
    assert _prove(chain, *tensors, publics=publics) == want


@pytest.mark.parametrize("case", ["a_L_meta", "a_R_meta", "a_O_meta", "publics_meta",
                                  "a_L_rows", "a_R_words", "v_blinding"])
def test_foreign_or_malformed_tensors_are_refused_before_any_copy(chain, monkeypatch, case):
    """A tensor on another device than the prover's, of another row count
    than its rows, in the words form, or a v_blinding tensor: ValueError
    before any copy to the device."""
    def untouched(*args, **kwargs):
        raise AssertionError("a copy to the device before the form check")

    B = len(A_VALS)
    limbs = [torch.from_numpy(_as_limbs(w)) for w in chain["words"]]
    fields = dict(zip(("a_L", "a_R", "a_O"), limbs), v=_limbs(A_VALS, (B, 1)),
                  v_blinding=_limbs(BLINDS, (B, 1)), publics=_limbs(chain["outs"], (B, 1)))
    name, _, how = case.rpartition("_")
    if how == "meta":
        fields[name] = torch.empty(tuple(np.shape(fields[name])), dtype=torch.int32,
                                   device="meta")
    elif how == "rows":
        fields[name] = fields[name][:1]
    elif how == "words":
        fields[name] = torch.from_numpy(np.ascontiguousarray(chain["words"][1]))
    else:
        name = case
        fields[name] = torch.from_numpy(fields[name])
    prover = bp.Prover([Transcript(LABEL) for _ in range(B)], cap=CAP, device="cpu")
    monkeypatch.setattr(bp, "_dev", untouched)
    monkeypatch.setattr(limb, "limbs_from_words", untouched)
    with pytest.raises(ValueError, match=f"^{name}: "):
        prover.prove(chain["circuit"], bp.ProverWitness(**fields))
