"""The BlindBid witness made from the committed values and the publics
(`blindbid.witness_wires`) against `blindbid.blindbid_witness`.

On the CPU the wrapper takes its plain version, `witness_wires_ref`, which
runs `blindbid.witness_values` on the rows' integers: its wires are the
limbs of `blindbid_witness`'s, zero past the gates, at list lengths 1, 4 and
7, on a mesh rank's rows and on edge inputs (d = 0, k = l - 1, the toggle
first and last, raw list items at or above l).

On a card (marker `cuda`, skipped without one) the two kernels, `mimc_chain`
and `witness_fanout`, are held exactly to the plain version at the main
path's shapes, each launch synchronised and its return code checked by the
wrapper, and `prove_batch` launches each kernel once and never the plain
version.  This file imports neither jax nor the JAX package, so it also runs
on a machine with a card:

    python -m pytest --noconftest tests/test_torch_witness.py
"""

import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu_torch.models import blindbid
from dusk_blindbidproof_tpu_torch.models.gadgets import MIMC_ROUNDS, blindbid_gates, blindbid_n_pad
from dusk_blindbidproof_tpu_torch.ops import fused, limb
from dusk_blindbidproof_tpu_torch.parallel import mesh as pmesh
from dusk_blindbidproof_tpu_torch.utils.curve_host import L

# small tensors: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _requests(B: int, list_len: int, seed: int = 0):
    gen = np.random.default_rng(seed)
    return [blindbid.make_prove_request(
        d=int(gen.integers(1, 2**62)), k=int(gen.integers(1, 2**62)),
        seed=int(gen.integers(1, 2**62)),
        pub_list_extra=[int(gen.integers(0, 2**62)) for _ in range(list_len - 1)],
        toggle_pos=i % list_len) for i in range(B)]


def _inputs(reqs, device="cpu"):
    """v and publics limbs of the requests, as prove_batch makes them."""
    B, list_len = len(reqs), len(reqs[0].pub_list)
    v = limb.ints_to_limbs_fast(
        [x % L for r in reqs for x in [r.d, r.k, r.y, r.y_inv]
         + [int(i == r.toggle) for i in range(list_len)]], (B, 4 + list_len))
    publics = limb.ints_to_limbs_fast(
        [x % L for r in reqs for x in [r.q, r.z_img, r.seed] + list(r.pub_list)],
        (B, 3 + list_len))
    return torch.from_numpy(v).to(device), torch.from_numpy(publics).to(device)


def _want(reqs, n_pad: int) -> torch.Tensor:
    """blindbid_witness's wires of the requests as [3, B, n_pad, NLIMBS] limbs."""
    out = np.zeros((3, len(reqs), n_pad, limb.NLIMBS), dtype=np.int32)
    for i, r in enumerate(reqs):
        for w, wire in enumerate(blindbid.blindbid_witness(r)):
            out[w, i, :len(wire)] = limb.ints_to_limbs_fast(wire)
    return torch.from_numpy(out)


def _wires(reqs, device="cpu"):
    n_pad = blindbid_n_pad(len(reqs[0].pub_list))
    v, publics = _inputs(reqs, device)
    return blindbid.witness_wires(v, publics,
                                  blindbid.mimc_constants_limbs(torch.device(device)),
                                  n_pad), n_pad


@pytest.mark.parametrize("list_len", [1, 4, 7])
def test_plain_wires_are_the_witness_limbs(list_len):
    reqs = _requests(3, list_len, seed=list_len)
    before = fused.launch_counts()
    got, n_pad = _wires(reqs)
    assert fused.launch_counts() == before
    assert got.dtype == torch.int32 and got.shape == (3, 3, n_pad, limb.NLIMBS)
    assert torch.equal(got, _want(reqs, n_pad))
    n1 = blindbid_gates(list_len)
    assert not got[:, :, n1:].any() and got[:, :, n1 - 1].any()


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_plain_wires_of_a_mesh_rank_rows(rank):
    """A rank makes the wires of its own rows alone: those of the whole
    batch's at its places (B = 6 over four ranks: rows 2, 2, 1, 1)."""
    reqs = _requests(6, 4, seed=11)
    mesh = pmesh.Mesh(bids=4, points=1, rank=rank, device=torch.device("cpu"),
                      bids_group=None, points_group=None)
    rows = pmesh.bid_rows(mesh, len(reqs))
    got, n_pad = _wires(reqs[rows])
    assert got.shape[1] == len(range(6)[rows]) >= 1
    assert torch.equal(got, _want(reqs, n_pad)[:, rows])


@pytest.mark.parametrize("toggle", ["first", "last"])
def test_plain_wires_on_edge_inputs(toggle):
    """d = 0, k = l - 1, raw list items at or above l (read mod l, as the
    publics are), the toggle at either end of the list."""
    list_len = 5
    place = 0 if toggle == "first" else list_len - 1
    req = blindbid.make_prove_request(d=0, k=L - 1, seed=L + 7,
                                      pub_list_extra=[L, L + 1, 2**256 - 1, 3],
                                      toggle_pos=place)
    other = blindbid.make_prove_request(d=L - 1, k=0, seed=0, pub_list_extra=[0, 0, 0, L],
                                        toggle_pos=list_len - 1 - place)
    got, n_pad = _wires([req, other])
    assert torch.equal(got, _want([req, other], n_pad))


def test_plain_wires_score_gates_take_the_hashed_y():
    """The score gates hold the y the hashes compute, not the request's."""
    req = _requests(1, 4, seed=3)[0]
    hashed = req.y
    req.y = (req.y + 1) % L
    got, n_pad = _wires([req])
    score = blindbid_gates(4) - 2
    assert limb.limbs_to_ints(got[0, 0, score]) == [hashed]


@pytest.mark.parametrize("case", ["v_rank", "publics_len", "constants", "n_pad", "rows"])
def test_witness_wires_refuse_what_is_not_a_witness(case):
    reqs = _requests(2, 4, seed=5)
    v, publics = _inputs(reqs)
    consts = blindbid.mimc_constants_limbs(torch.device("cpu"))
    n_pad = blindbid_n_pad(4)
    if case == "v_rank":
        v = v[0]
    elif case == "publics_len":
        publics = publics[:, :-1]
    elif case == "constants":
        consts = consts[:-1]
    elif case == "n_pad":
        n_pad = blindbid_gates(4) - 1
    else:
        publics = publics[:1]
    with pytest.raises(ValueError):
        blindbid.witness_wires(v, publics, consts, n_pad)


@pytest.mark.parametrize("launch", ["mimc_chain", "witness_fanout"])
def test_witness_launches_refuse_cpu_tensors(launch):
    """The two launches take CUDA tensors alone: the plain version is the
    application's, and a CPU tensor never reaches the library."""
    reqs = _requests(2, 4, seed=6)
    v, publics = _inputs(reqs)
    before = fused.launch_counts()
    with pytest.raises(ValueError, match="CUDA device"):
        if launch == "mimc_chain":
            fused.mimc_chain(v, publics, blindbid.mimc_constants_limbs(torch.device("cpu")))
        else:
            scratch = torch.zeros((2, fused.MIMC_SCRATCH_ROWS, limb.NLIMBS), dtype=torch.int32)
            fused.witness_fanout(v, publics, scratch, blindbid_n_pad(4), 4)
    assert fused.launch_counts() == before


def test_the_kernel_rounds_are_the_gadget_rounds():
    assert fused.MIMC_ROUNDS == MIMC_ROUNDS == len(blindbid.mimc_constants())
    assert fused.MIMC_SCRATCH_ROWS == 4 * MIMC_ROUNDS + 4


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,list_len,rows", [
    (1, 4, None), (16, 4, None), (256, 4, None), (16, 202, None), (256, 4, slice(64, 128)),
], ids=["B1-L4", "B16-L4", "B256-L4", "B16-L202", "rank1-of-4-B256-L4"])
def test_kernels_match_plain(cuda, B, list_len, rows):
    reqs = _requests(B, list_len, seed=B + list_len)
    if rows is not None:
        reqs = reqs[rows]
    v, publics = _inputs(reqs, cuda)
    consts = blindbid.mimc_constants_limbs(cuda)
    n_pad = blindbid_n_pad(list_len)
    before = fused.launch_counts()
    got = blindbid.witness_wires(v, publics, consts, n_pad)
    torch.cuda.synchronize()
    after = fused.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in ("mimc_chain", "witness_fanout")) for k in after}
    want = blindbid.witness_wires_ref(v.cpu(), publics.cpu(), consts.cpu(), n_pad)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_prove_batch_launches_each_witness_kernel_once(cuda, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("the plain witness on the card's path")

    reqs = _requests(4, 4, seed=9)
    blindbid.prove_batch(reqs, rng=np.random.default_rng(1), device=cuda)  # warm: tables
    monkeypatch.setattr(blindbid, "witness_wires_ref", plain)
    monkeypatch.setattr(blindbid, "blindbid_witness", plain)
    before = fused.launch_counts()
    proofs = blindbid.prove_batch(reqs, rng=np.random.default_rng(1), device=cuda)
    torch.cuda.synchronize()
    after = fused.launch_counts()
    assert after["mimc_chain"] - before["mimc_chain"] == 1
    assert after["witness_fanout"] - before["witness_fanout"] == 1
    oks = blindbid.verify_batch(
        [blindbid.VerifyRequest(proof=p, score=r.q, z_img=r.z_img, seed=r.seed,
                                pub_list=r.pub_list) for p, r in zip(proofs, reqs)],
        device=cuda)
    assert oks == [True] * len(reqs)
