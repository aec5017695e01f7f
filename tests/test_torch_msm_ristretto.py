"""MSM and Ristretto of the port against host ground truth and the JAX
package.

The tier-1 tests hold the port's `msm`, `bucket_msm` (extended and
affine-Niels), `_bit_msm` and window tables to host-integer MSMs computed
with the JAX package's `curve_host` (affine equality), and its device
Ristretto compress/decompress to the RFC 9496 vectors.  The tests that run
the JAX package's own MSM, table build and compression are marked slow:
each jit-compiles for tens of seconds to minutes on the CPU.
"""

import random

import jax
import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu.utils import curve_host as jhost
from dusk_blindbidproof_tpu_torch.ops import edwards as te
from dusk_blindbidproof_tpu_torch.ops import limb as tl
from dusk_blindbidproof_tpu_torch.ops import msm as tm
from dusk_blindbidproof_tpu_torch.ops import ristretto as tr
from dusk_blindbidproof_tpu_torch.utils import curve_host as host

# small tensors: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

# RFC 9496 §A.1: encodings of 0*B .. 7*B
SMALL_MULTIPLES = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
    "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
    "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
    "da80862773358b466ffadfe0b3293ab3d9fd53c5ea6c955358f568322daf6a57",
    "e882b131016b52c1d3337080187cf768423efccbb517bb495ab812c4160ff44e",
    "f64746d3c92b13050ed8d80236a7f0007c3b3f962f5ba793d19a601ebb1df403",
    "44f53520926ec81fbd5a387845beb7df85a96a24ece18738bdcfa6a7822a176d",
]

G = host.ED25519_BASEPOINT
JG = jhost.ED25519_BASEPOINT


def _points(seed: int, n: int):
    """Random multiples of the base point, as the JAX package's host points."""
    rng = random.Random(seed)
    return [JG.scalar_mul(rng.randrange(1, jhost.L)) for _ in range(n)]


def _host_msm(points, scalars):
    acc = jhost.EdwardsPoint.identity()
    for p, s in zip(points, scalars):
        acc = acc + p.scalar_mul(s)
    return acc


def _host_niels(points):
    """Affine-Niels rows (y - x, y + x, 2 d x y, 0) as limbs."""
    rows = []
    for p in points:
        x, y = p.affine()
        rows.append([
            tl.int_to_limbs((y - x) % jhost.P),
            tl.int_to_limbs((y + x) % jhost.P),
            tl.int_to_limbs(2 * jhost.D * x * y % jhost.P),
            tl.int_to_limbs(0),
        ])
    return torch.from_numpy(np.array(rows, dtype=np.int32))


def _same(dev_pts, host_pts) -> bool:
    """Affine equality of the port's points with the JAX package's host points."""
    got = [jhost.EdwardsPoint(p.X, p.Y, p.Z, p.T).affine() for p in te.to_host(dev_pts)]
    return got == [p.affine() for p in host_pts]


def test_msm_vs_host():
    pts = _points(1, 6)
    rng = random.Random(2)
    scalars = [0, 1, jhost.L - 1] + [rng.randrange(jhost.L) for _ in range(3)]
    got = tm.msm(te.from_host(pts), torch.from_numpy(tl.ints_to_limbs(scalars)))
    assert _same(got, [_host_msm(pts, scalars)])


@pytest.mark.parametrize("niels", [False, True], ids=["extended", "niels"])
def test_bucket_msm_vs_host(niels):
    """The sort/scan/histogram path (forced with Niels rows, or with more
    items than the bit path takes), batched over two digit rows."""
    n = 6 if niels else tm.BIT_MSM_MAX_ITEMS + 40
    pts = _points(3, 6)
    pts = (pts * (n // 6 + 1))[:n]
    rng = np.random.default_rng(4)
    digits = rng.integers(0, 64, size=(2, n)).astype(np.int32)
    digits[0, :3] = [0, 63, 63]  # zero digit and repeated buckets
    table = _host_niels(pts) if niels else te.from_host(pts)
    got = tm.bucket_msm(table, torch.from_numpy(digits), niels=niels)
    want = [_host_msm(pts, [int(d) for d in row]) for row in digits]
    assert _same(got, want)


def test_bit_msm_vs_host():
    pts = _points(5, 9)
    digits = np.array([[0, 1, 8191, 4096, 77, 5, 5, 3000, 12]], dtype=np.int32)
    got = tm._bit_msm(te.from_host(pts), torch.from_numpy(digits))
    assert _same(got, [_host_msm(pts, digits[0].tolist())])


def test_prescaled_tables_vs_host():
    pts = _points(6, 2)
    table = tm.prescale_windows(te.from_host(pts))  # [2, W, 4, NL]
    want = [p.scalar_mul(1 << (13 * w)) for p in pts for w in range(tm.WINDOWS)]
    assert _same(table, want)


def test_compress_decompress_rfc9496():
    pts = [host.EdwardsPoint.identity()] + [G.scalar_mul(k) for k in range(1, 8)]
    enc = tr.compress(te.from_host(pts))
    got = [bytes(r) for r in tl.limbs_to_bytes_le(enc)]
    assert [g.hex() for g in got] == SMALL_MULTIPLES
    s = torch.from_numpy(tl.limbs_from_bytes_le(
        np.frombuffer(b"".join(got), dtype=np.uint8).reshape(-1, 32)))
    dec, valid = tr.decompress(s)
    assert valid.all()
    assert [jhost.ristretto_compress(jhost.EdwardsPoint(p.X, p.Y, p.Z, p.T))
            for p in te.to_host(dec)] == got


def test_decompress_rejects_non_square():
    bad = bytearray(bytes.fromhex(SMALL_MULTIPLES[2]))
    bad[0] ^= 2  # still even and < p, no longer a valid encoding
    assert jhost.ristretto_decompress(bytes(bad)) is None
    s = torch.from_numpy(tl.limbs_from_bytes_le(np.frombuffer(bytes(bad), dtype=np.uint8)))
    pt, valid = tr.decompress(s)
    assert not bool(valid)
    assert te.eq_points(pt, te.identity()).all()


# ---------------------------------------------------------------------------
# Against the JAX package's own functions (slow: jit compiles)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_tables_from_reference_match_own_tables():
    from dusk_blindbidproof_tpu.ops import msm as jm

    table_np, _ = jm.pedersen_tables(8)
    niels_np, _ = jm.pedersen_tables_niels(8)
    table, niels = tm.tables_from_reference(table_np, niels_np, "cpu")
    own, _ = tm.pedersen_tables(8, torch.device("cpu"))
    own_niels, _ = tm.pedersen_tables_niels(8, torch.device("cpu"))
    canon = lambda x: tl.canon(tl.FP, x)
    assert torch.equal(canon(table), canon(own))
    assert torch.equal(canon(niels), canon(own_niels))


@pytest.mark.slow
@pytest.mark.parametrize("niels", [False, True], ids=["extended", "niels"])
def test_bucket_and_bit_msm_match_jax(niels):
    from dusk_blindbidproof_tpu.ops import msm as jm

    pts = _points(7, 8)
    digits = np.random.default_rng(8).integers(0, 8192, size=(2, 8)).astype(np.int32)
    table = _host_niels(pts) if niels else te.from_host(pts)
    want = np.asarray(jax.jit(
        lambda p, d: jm.bucket_msm(jax.numpy.broadcast_to(p, (2, *p.shape)), d, niels=niels)
    )(table.numpy(), digits))
    got = tm.bucket_msm(table, torch.from_numpy(digits), niels=niels)
    assert te.eq_points(got, torch.from_numpy(want.copy())).all()
    if not niels:
        want_bit = np.asarray(jax.jit(jm._bit_msm)(table.numpy(), digits))
        got_bit = tm._bit_msm(table, torch.from_numpy(digits))
        assert te.eq_points(got_bit, torch.from_numpy(want_bit)).all()
    scalars = np.stack([tl.int_to_limbs(int(d) * 12345 % jhost.L) for d in digits[0]])
    want_msm = np.asarray(jax.jit(jm.msm)(te.from_host(pts).numpy(), scalars))
    got_msm = tm.msm(te.from_host(pts), torch.from_numpy(scalars))
    assert te.eq_points(got_msm, torch.from_numpy(want_msm)).all()


@pytest.mark.slow
def test_compress_decompress_match_jax():
    from dusk_blindbidproof_tpu.ops import ristretto as jr

    pts = te.from_host([G.scalar_mul(k) for k in range(1, 6)])
    want = np.asarray(jax.jit(jr.compress)(pts.numpy()))
    got = tr.compress(pts)
    assert (want == got.numpy()).all()
    want_pts, want_ok = jax.jit(jr.decompress)(want)
    got_pts, got_ok = tr.decompress(got)
    assert (np.asarray(want_ok) == got_ok.numpy()).all()
    assert te.eq_points(got_pts, torch.from_numpy(np.asarray(want_pts))).all()
