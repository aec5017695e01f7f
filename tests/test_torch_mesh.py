"""The port's mesh (parallel/mesh.py) on 4 CPU ranks over gloo.

`spawn` starts the ranks once for the module (rendezvous through a FileStore,
no port); every rank makes the 4 x 1, 1 x 4 and 2 x 2 meshes and runs its
share of every case, and the tests read what the ranks returned:

  * `make_mesh`: each rank's place in each layout; a layout that does not
    cover the world raises; the default device raises without a GPU;
  * `shard_batch_over_bids` / `gather_rows`: contiguous rows at B = 3, 5 and
    16 over bids 2 and 4 (one rank empty at B = 3 over 4), gathered back;
  * `sharded_msm` at n = 16 over points 4 against the port's `msm.msm` and the
    JAX package's `curve_host` sums; `sharded_bucket_step` at 2 x 2 against
    `bucket_msm`; `dryrun_multichip`;
  * `Prover` / `Verifier(mesh=)` at CAP = 32 on tests/test_torch_batch.py's
    power-chain circuit, B = 5 over 2 x 2: each proof's bytes equal
    mesh=None's (proved in this process while the ranks run) and the JAX host
    oracle's for its place, on every rank; the honest batch verifies; a
    tampered proof or public turns its own place only; a malformed proof
    raises ProofError on every rank.

The slow cases run `prove_batch` / `verify_batch` at n = 2048 over bids 4
against mesh=None, and `sharded_msm` against the JAX package's sharded MSM on
the 8-device CPU mesh of conftest.py.  Tolerance: none; bytes, canonical
values and booleans are compared.
"""

import threading

import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu_torch.models import r1cs as tr1cs
from dusk_blindbidproof_tpu_torch.models.bulletproofs import (
    CompiledCircuit,
    Prover,
    ProverWitness,
    Verifier,
)
from dusk_blindbidproof_tpu_torch.models.proof_struct import R1CSProof
from dusk_blindbidproof_tpu_torch.models.transcript_protocol import ProofError
from dusk_blindbidproof_tpu_torch.ops import edwards, limb, msm
from dusk_blindbidproof_tpu_torch.parallel import mesh as pmesh
from dusk_blindbidproof_tpu_torch.utils import curve_host as host
from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript

torch.set_num_threads(1)

RANKS = 4
LAYOUTS = ((4, 1), (1, 4), (2, 2))
ROW_CASES = [(bids, B) for bids in (2, 4) for B in (3, 5, 16)]
MSM_N = 16
BUCKET_SHAPE = (4, 8)  # batch x items of the sharded bucket step

# tests/test_torch_batch.py's circuit and places
CAP = 32
GATES = 20
LABEL = b"torch-port-batch"
B = 5
PROVER_LAYOUT = (2, 2)
TAMPERED = {1: "t_x", 4: "public"}  # as tests/test_torch_batch.py's B = 5 pass
MALFORMED_PLACE = 4  # on the second bids index: its ranks raise, the others must too


def _artifact(r1cs):
    cs = r1cs.VerifierCS()
    a = cs.commit_var()
    pub = cs.public_var()
    x = r1cs.LC.of(a)
    for _ in range(GATES):
        _, _, o = cs.multiply(x, r1cs.LC.of(a))
        x = r1cs.LC.of(o)
    cs.constrain(x - pub)
    return cs.artifact()


def _place(i):
    """The committed value, its blinding and the chain's gates at place i."""
    a, blind = 987654321 + 1000003 * i, 4242 + i
    a_L, a_R, a_O, x = [], [], [], a
    for _ in range(GATES):
        a_L.append(x)
        a_R.append(a)
        x = x * a % host.L
        a_O.append(x)
    return a, blind, a_L, a_R, a_O, x


def _batch(circuit):
    """(values, blindings, witness, publics) of places 0 .. B-1."""
    places = [_place(i) for i in range(B)]

    def rows(k):
        arr = np.zeros((B, circuit.n_pad, limb.NLIMBS), dtype=np.int32)
        for i, p in enumerate(places):
            arr[i, :GATES] = limb.ints_to_limbs_fast(p[k])
        return arr

    witness = ProverWitness(
        a_L=rows(2), a_R=rows(3), a_O=rows(4),
        v=limb.ints_to_limbs_fast([p[0] for p in places], (B, 1)),
        v_blinding=limb.ints_to_limbs_fast([p[1] for p in places], (B, 1)),
        publics=limb.ints_to_limbs_fast([p[5] for p in places], (B, 1)),
    )
    return [[p[0]] for p in places], [[p[1]] for p in places], witness, [p[5] for p in places]


def _prove(circuit, device, mesh=None):
    values, blinds, witness, publics = _batch(circuit)
    prover = Prover([Transcript(LABEL) for _ in range(B)], cap=CAP, device=device, mesh=mesh)
    commitments = prover.commit_batch(values, blinds)
    return prover.prove(circuit, witness), commitments, publics


def _verify(circuit, proofs, commitments, publics, mesh):
    verifier = Verifier([Transcript(LABEL) for _ in range(B)], cap=CAP, mesh=mesh)
    verifier.commit_batch(commitments)
    return verifier.verify(circuit, proofs, commitments,
                           limb.ints_to_limbs_fast(publics, (B, 1)))


def _msm_inputs():
    gen = np.random.default_rng(11)
    scalars = [int.from_bytes(gen.bytes(32), "little") % host.L for _ in range(2 * MSM_N)]
    points = [host.ED25519_BASEPOINT.scalar_mul(k) for k in scalars[MSM_N:]]
    return points, scalars[:MSM_N]


def _bucket_inputs():
    gen = np.random.default_rng(12)
    n = BUCKET_SHAPE[0] * BUCKET_SHAPE[1]
    pts = [host.ED25519_BASEPOINT.scalar_mul(int(k)) for k in gen.integers(1, 1 << 60, size=n)]
    points = edwards.from_host(pts).reshape(*BUCKET_SHAPE, 4, limb.NLIMBS)
    digits = torch.from_numpy(gen.integers(0, msm.D_BUCKETS, size=BUCKET_SHAPE).astype(np.int32))
    return points, digits


def _canon_points(x: torch.Tensor) -> list:
    return [(p.X * pow(p.Z, -1, host.P) % host.P, p.Y * pow(p.Z, -1, host.P) % host.P)
            for p in edwards.to_host(x)]


# ---------------------------------------------------------------------------
# The ranks' job
# ---------------------------------------------------------------------------


def _rank_job(dev):
    torch.set_num_threads(1)
    out = {}
    meshes = {}
    for layout in LAYOUTS:
        m = pmesh.make_mesh(bids=layout[0], points=layout[1], device=dev)
        meshes[layout] = m
        out["place", layout] = (m.bids, m.points, m.rank, m.bid_index, m.point_index, m.device.type)
    for what, call in (("mismatch", lambda: pmesh.make_mesh(bids=3, points=2, device=dev)),
                       ("default device", lambda: pmesh.make_mesh(bids=4))):
        try:
            call()
        except (ValueError, RuntimeError) as exc:  # the raise is what the tests read
            out[what] = (type(exc).__name__, str(exc))

    for bids, batch in ROW_CASES:
        m = meshes[(bids, 4 // bids)]
        rows = pmesh.shard_batch_over_bids(m, list(range(batch)))
        tensor_rows = pmesh.shard_batch_over_bids(m, torch.arange(batch * 2).reshape(batch, 2))
        out["rows", bids, batch] = (rows, pmesh.gather_rows(m, rows),
                                    pmesh.gather_rows(m, tensor_rows).tolist())

    points, scalars = _msm_inputs()
    got = pmesh.sharded_msm(meshes[(1, 4)], edwards.from_host(points),
                            torch.from_numpy(limb.ints_to_limbs(scalars)))
    out["sharded_msm"] = _canon_points(got)
    bucket_pts, bucket_digits = _bucket_inputs()
    out["bucket"] = _canon_points(pmesh.sharded_bucket_step(meshes[(2, 2)], bucket_pts,
                                                            bucket_digits))
    pmesh.dryrun_multichip(meshes[(4, 1)])
    out["dryrun"] = True

    m = meshes[PROVER_LAYOUT]
    circuit = CompiledCircuit.compile(_artifact(tr1cs), dev)
    proofs, commitments, publics = _prove(circuit, None, mesh=m)
    out["proofs"] = [p.to_bytes() for p in proofs]
    out["commitments"] = commitments
    out["honest"] = _verify(circuit, proofs, commitments, publics, m)
    bad_proofs = [R1CSProof.from_bytes(p.to_bytes()) for p in proofs]
    bad_publics = list(publics)
    for i, what in TAMPERED.items():
        if what == "t_x":
            bad_proofs[i].t_x = (bad_proofs[i].t_x + 1) % host.L
        else:
            bad_publics[i] = (bad_publics[i] + 1) % host.L
    out["tampered"] = _verify(circuit, bad_proofs, commitments, bad_publics, m)
    malformed = [R1CSProof.from_bytes(p.to_bytes()) for p in proofs]
    malformed[MALFORMED_PLACE].A_I1 = b"\x01" + bytes(31)  # odd: not a canonical encoding
    try:
        _verify(circuit, malformed, commitments, publics, m)
    except ProofError as exc:  # the raise is what the tests read
        out["malformed"] = str(exc)
    return out


def _references() -> dict:
    """What the ranks' results are held to, computed in this process while
    the ranks run: mesh=None's proofs and commitments, the JAX host oracle's
    proof and commitments of every place, the port's unsharded MSMs."""
    from dusk_blindbidproof_tpu.models import r1cs as jr1cs
    from dusk_blindbidproof_tpu.utils import host_oracle as oracle
    from dusk_blindbidproof_tpu.utils.merlin import Transcript as JaxTranscript

    ref = {}
    circuit = CompiledCircuit.compile(_artifact(tr1cs), torch.device("cpu"))
    proofs, ref["plain commitments"], _ = _prove(circuit, "cpu")
    ref["plain proofs"] = [p.to_bytes() for p in proofs]
    ref["oracle"] = []
    for i in range(B):
        a, blind, a_L, a_R, a_O, out = _place(i)
        want, trace = oracle.host_prove(_artifact(jr1cs), JaxTranscript(LABEL), [a], [blind],
                                        a_L, a_R, a_O, [out], CAP)
        ref["oracle"].append((want.to_bytes(), trace.commitments))
    points, scalars = _msm_inputs()
    ref["msm"] = _canon_points(msm.msm(edwards.from_host(points),
                                       torch.from_numpy(limb.ints_to_limbs(scalars))))
    ref["bucket"] = _canon_points(msm.bucket_msm(*_bucket_inputs()))
    return ref


@pytest.fixture(scope="module")
def ranks():
    """(what each rank returned, the references of `_references`)."""
    result = {}

    def job():
        result["ranks"] = pmesh.spawn(_rank_job, RANKS, device="cpu", timeout=900)

    thread = threading.Thread(target=job)
    thread.start()
    try:
        ref = _references()
    finally:
        thread.join()
    assert "ranks" in result, "the ranks' job failed: see its traceback above"
    return result["ranks"], ref


# ---------------------------------------------------------------------------
# make_mesh, rows, launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda t: f"{t[0]}x{t[1]}")
def test_make_mesh_layout(ranks, layout):
    bids, points = layout
    got = [r["place", layout] for r in ranks[0]]
    assert got == [(bids, points, r, r // points, r % points, "cpu") for r in range(RANKS)]


def test_make_mesh_mismatch_raises(ranks):
    for r in ranks[0]:
        assert r["mismatch"][0] == "ValueError" and "3 x 2" in r["mismatch"][1]


def test_make_mesh_default_device_raises_without_gpu(ranks):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    for r in ranks[0]:
        assert r["default device"][0] == "RuntimeError"
        assert "no CUDA device" in r["default device"][1]


@pytest.mark.parametrize("bids, batch", ROW_CASES)
def test_shard_batch_over_bids(ranks, bids, batch):
    points = RANKS // bids
    want = [list(part) for part in np.array_split(np.arange(batch), bids)]
    for rank, r in enumerate(ranks[0]):
        rows, gathered, gathered_tensor = r["rows", bids, batch]
        assert rows == want[rank // points]
        assert gathered == list(range(batch))
        assert gathered_tensor == torch.arange(batch * 2).reshape(batch, 2).tolist()
    if batch < bids:
        assert any(not r["rows", bids, batch][0] for r in ranks[0])


def test_default_backend_rule():
    assert pmesh.default_backend("cpu", 4) == "gloo"
    assert pmesh.default_backend("cuda:0", 4) == "gloo"  # ranks share one card
    if torch.cuda.device_count() < 4:
        assert pmesh.default_backend("cuda", 4) == "gloo"


def _fails_on_rank_1(dev):
    import time

    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    time.sleep(600)  # the other ranks would outlast the test: spawn must end them


def test_spawn_raises_when_a_rank_fails():
    import time

    t0 = time.monotonic()
    with pytest.raises(Exception, match="rank 1 fails"):
        pmesh.spawn(_fails_on_rank_1, 3, device="cpu", timeout=300)
    assert time.monotonic() - t0 < 120


# ---------------------------------------------------------------------------
# MSMs over the points axis
# ---------------------------------------------------------------------------


def test_sharded_msm_matches_port_msm(ranks):
    for r in ranks[0]:
        assert r["sharded_msm"] == ranks[1]["msm"]


def test_sharded_msm_matches_host_sum(ranks):
    from dusk_blindbidproof_tpu.utils import curve_host as jhost

    points, scalars = _msm_inputs()
    acc = jhost.EdwardsPoint.identity()
    for p, k in zip(points, scalars):
        acc = acc + jhost.EdwardsPoint(p.X, p.Y, p.Z, p.T).scalar_mul(k)
    zi = pow(acc.Z, -1, jhost.P)
    for r in ranks[0]:
        assert r["sharded_msm"] == [(acc.X * zi % jhost.P, acc.Y * zi % jhost.P)]


def test_sharded_bucket_step_matches_bucket_msm(ranks):
    for r in ranks[0]:
        assert r["bucket"] == ranks[1]["bucket"]


def test_dryrun_multichip(ranks):
    assert all(r["dryrun"] for r in ranks[0])


# ---------------------------------------------------------------------------
# Prover / Verifier with a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(B))
def test_mesh_proof_is_unsharded_and_oracle_proof(ranks, i):
    rank_out, ref = ranks
    want, want_commitments = ref["oracle"][i]
    assert ref["plain proofs"][i] == want
    assert ref["plain commitments"][i] == want_commitments
    for r in rank_out:  # every rank returns the whole batch
        assert r["proofs"][i] == want
        assert r["commitments"][i] == want_commitments


def test_mesh_batch_verifies(ranks):
    assert all(r["honest"] == [True] * B for r in ranks[0])


@pytest.mark.parametrize("i", range(B))
def test_mesh_tampering_turns_its_own_place_only(ranks, i):
    for r in ranks[0]:
        assert r["tampered"][i] == (i not in TAMPERED)


def test_mesh_malformed_proof_raises_on_every_rank(ranks):
    assert all("non-canonical" in r["malformed"] for r in ranks[0])


def test_mesh_and_device_are_exclusive():
    from dusk_blindbidproof_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(1, 1, 0, torch.device("cpu"), None, None)
    with pytest.raises(ValueError):
        Prover([Transcript(LABEL)], cap=8, device="cpu", mesh=mesh)


# ---------------------------------------------------------------------------
# Slow: full size, and the JAX package's sharded MSM
# ---------------------------------------------------------------------------


def _blindbid_rank_job(dev):
    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch, verify_batch

    torch.set_num_threads(1)
    m = pmesh.make_mesh(bids=4, points=1, device=dev)
    reqs = _blindbid_requests()
    proofs = prove_batch(reqs, rng=np.random.default_rng(5), mesh=m)
    return [_blob(p) for p in proofs], verify_batch(_verify_requests(reqs, proofs), mesh=m)


def _blindbid_requests():
    from dusk_blindbidproof_tpu_torch.models.blindbid import make_prove_request

    return [make_prove_request(d=100 + i, k=200 + i, seed=300 + i, pub_list_extra=[7, 8, 9],
                               toggle_pos=i % 4) for i in range(4)]


def _verify_requests(reqs, proofs):
    from dusk_blindbidproof_tpu_torch.models.blindbid import VerifyRequest

    return [VerifyRequest(proof=p, score=r.q, z_img=r.z_img, seed=r.seed, pub_list=r.pub_list)
            for p, r in zip(proofs, reqs)]


def _blob(proof):
    from dusk_blindbidproof_tpu_torch.models.blindbid import proof_blob

    return proof_blob(proof)


@pytest.mark.slow
def test_prove_verify_batch_sharded_byte_identical():
    """The counterpart of tests/test_mesh.py's sharded prove/verify: n = 2048,
    B = 4 over bids 4, byte-identical to mesh=None."""
    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch

    ranks = pmesh.spawn(_blindbid_rank_job, 4, device="cpu", timeout=3000)
    plain = prove_batch(_blindbid_requests(), rng=np.random.default_rng(5), device="cpu")
    for blobs, verdicts in ranks:
        assert blobs == [_blob(p) for p in plain]
        assert verdicts == [True] * 4


def _jax_msm_inputs():
    gen = np.random.default_rng(13)
    scalars = [int.from_bytes(gen.bytes(32), "little") % host.L for _ in range(2 * MSM_N)]
    return [host.ED25519_BASEPOINT.scalar_mul(k) for k in scalars[MSM_N:]], scalars[:MSM_N]


def _msm_rank_job(dev):
    torch.set_num_threads(1)
    m = pmesh.make_mesh(bids=1, points=4, device=dev)
    points, scalars = _jax_msm_inputs()
    return _canon_points(pmesh.sharded_msm(m, edwards.from_host(points),
                                           torch.from_numpy(limb.ints_to_limbs(scalars))))


@pytest.mark.slow
def test_sharded_msm_matches_jax_sharded_msm():
    """The JAX package's sharded MSM on the 8-device CPU mesh of conftest.py
    and the port's over 4 gloo ranks, on the same inputs."""
    import jax
    import jax.numpy as jnp

    from dusk_blindbidproof_tpu.ops import edwards as jedwards
    from dusk_blindbidproof_tpu.ops import limb as jlimb
    from dusk_blindbidproof_tpu.parallel import mesh as jmesh
    from dusk_blindbidproof_tpu.utils import curve_host as jhost

    points, scalars = _jax_msm_inputs()
    jm = jmesh.make_mesh(8, bids=1, points=8)
    jpts = jedwards.from_host([jhost.EdwardsPoint(p.X, p.Y, p.Z, p.T) for p in points])
    want = jmesh.sharded_msm(jm, jpts, jnp.asarray(jlimb.ints_to_limbs(scalars)))
    w = jedwards.to_host(jax.device_get(want))[0]
    zi = pow(w.Z, -1, jhost.P)
    got = pmesh.spawn(_msm_rank_job, 4, device="cpu", timeout=900)
    assert all(g == [(w.X * zi % jhost.P, w.Y * zi % jhost.P)] for g in got)
