"""The two chains of the port, `fused.double_chain` (window tables) and
`fused.sqr_chain` (runs of squarings), and the functions routed through
them: `msm.prescale_windows`, `ristretto._pow2k`, `pow_p58`, `invert`,
`decompress`.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
to the same plain versions in tests/test_torch_kernels.py.  Here the plain
versions are held to the stepwise `double_ref` / `mul_rows_ref` loops they
replace, to host integers (`curve_host` multiples, `pow`), and to the JAX
package's `prescale_windows` and `_pow2k` on the same numpy-seeded inputs.
Everything is compared after canonicalisation, tolerance 0 (integers).
"""

import random

import jax
import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu.ops import msm as jm
from dusk_blindbidproof_tpu.ops import ristretto as jr
from dusk_blindbidproof_tpu.utils import curve_host as jhost
from dusk_blindbidproof_tpu_torch.ops import edwards as te
from dusk_blindbidproof_tpu_torch.ops import fused as tf
from dusk_blindbidproof_tpu_torch.ops import limb as tl
from dusk_blindbidproof_tpu_torch.ops import msm as tm
from dusk_blindbidproof_tpu_torch.ops import ristretto as tr

# small tensors: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

P = jhost.P


def _rows(seed: int, shape) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 8193, size=shape, dtype=np.int32)
    x.reshape(-1, shape[-1])[0] = 8192  # max-bound row
    return x


def _canon(x) -> np.ndarray:
    return tl.canon(tl.FP, torch.from_numpy(np.array(x))).numpy()


def _host_points(seed: int, n: int):
    rng = random.Random(seed)
    return [jhost.ED25519_BASEPOINT.scalar_mul(rng.randrange(1, jhost.L)) for _ in range(n)]


def _affine(dev_pts):
    return [jhost.EdwardsPoint(p.X, p.Y, p.Z, p.T).affine() for p in te.to_host(dev_pts)]


def _values(x: torch.Tensor) -> list[int]:
    return [tl.limbs_to_int(r) for r in tl.canon(tl.FP, x).numpy().reshape(-1, tl.NLIMBS)]


# --- the doubling chain -------------------------------------------------------


@pytest.mark.parametrize("windows,steps", [(4, 3), (3, 13), (2, 1), (1, 5)])
def test_double_chain_matches_stepwise_loop(windows, steps):
    """Any rows, not only curve points: doubling is a polynomial identity."""
    p = torch.from_numpy(_rows(1, (2, 3, 4, tl.NLIMBS)))
    p[0, 1] = te.identity()
    want, cur = [p], p
    for _ in range(windows - 1):
        for _ in range(steps):
            cur = tf.double_ref(cur)
        want.append(cur)
    want = torch.stack(want, dim=-3)
    got = tf.double_chain_ref(p, windows, steps)
    assert got.shape == (2, 3, windows, 4, tl.NLIMBS)
    assert torch.equal(got, want)
    assert torch.equal(tf.double_chain(p, windows, steps), want)  # CPU: the plain version


@pytest.mark.parametrize("n", [1, 8])
def test_double_chain_gives_host_multiples(n):
    pts = _host_points(2, n)
    got = tf.double_chain(te.from_host(pts), 4, 13)
    want = [p.scalar_mul(1 << (13 * w)).affine() for p in pts for w in range(4)]
    assert _affine(got) == want


@pytest.mark.parametrize("bad", [(0, 13), (3, 0)], ids=["no-window", "no-step"])
def test_double_chain_refuses_empty_chains(bad):
    p = te.identity((2,))
    with pytest.raises(ValueError):
        tf.double_chain(p, *bad)
    with pytest.raises(ValueError):
        tf.double_chain_ref(p, *bad)


def test_prescale_windows_is_the_13_step_chain():
    pts = te.from_host(_host_points(3, 3))
    table = tm.prescale_windows(pts)
    assert table.shape == (3, tm.WINDOWS, 4, tl.NLIMBS)
    assert torch.equal(table, tf.double_chain_ref(pts, tm.WINDOWS, tl.LIMB_BITS))
    # the values the stepwise loop over edwards.double gave before the chain
    nxt = pts
    for _ in range(tl.LIMB_BITS):
        nxt = te.double(nxt)
    assert torch.equal(table[:, 1], nxt) and torch.equal(table[:, 0], pts)
    assert _affine(table[:, -1]) == [
        p.scalar_mul(1 << (13 * (tm.WINDOWS - 1))).affine() for p in _host_points(3, 3)
    ]


def test_pedersen_tables_go_through_the_chain():
    tm.pedersen_tables.cache_clear()
    table, layout = tm.pedersen_tables(2, torch.device("cpu"))
    assert table.shape == (6, tm.WINDOWS, 4, tl.NLIMBS) and layout["B"] == 4
    gens = tm._host_points(2)
    want = [g.scalar_mul(1 << (13 * w)).affine() for g in gens for w in (0, 1, tm.WINDOWS - 1)]
    got = te.to_host(table[:, [0, 1, tm.WINDOWS - 1]])
    assert [p.affine() for p in got] == want
    tm.pedersen_tables.cache_clear()


@pytest.mark.slow
def test_prescale_windows_matches_jax():
    x = _rows(4, (3, 4, tl.NLIMBS))
    want = np.asarray(jax.jit(jm.prescale_windows)(x))
    got = tm.prescale_windows(torch.from_numpy(x))
    assert (_canon(want) == _canon(got)).all()


# --- the squaring chain -------------------------------------------------------


@pytest.mark.parametrize("ctx", [tl.FP, tl.FL], ids=["fp", "fl"])
@pytest.mark.parametrize("k", [1, 2, 5, 20])
def test_sqr_chain_matches_stepwise_loop_and_pow(ctx, k):
    x = torch.from_numpy(_rows(5, (2, 4, tl.NLIMBS)))
    x[0, 1] = 0
    want = x
    for _ in range(k):
        want = tf.mul_rows_ref(ctx, want, want)
    got = tf.sqr_chain_ref(ctx, x, k)
    assert torch.equal(got, want)
    assert torch.equal(tf.sqr_chain(ctx, x, k), want)  # CPU: the plain version
    vals = [tl.limbs_to_int(r) for r in x.numpy().reshape(-1, tl.NLIMBS)]
    canon = tl.canon(ctx, got).numpy().reshape(-1, tl.NLIMBS)
    assert [tl.limbs_to_int(r) for r in canon] == [pow(v, 2**k, ctx.modulus) for v in vals]


def test_sqr_chain_refuses_empty_chain():
    x = torch.from_numpy(_rows(6, (2, tl.NLIMBS)))
    with pytest.raises(ValueError):
        tf.sqr_chain(tl.FP, x, 0)
    with pytest.raises(ValueError):
        tf.sqr_chain_ref(tl.FP, x, 0)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 10, 50])
def test_pow2k_gives_host_powers(k):
    x = torch.from_numpy(_rows(7, (5, tl.NLIMBS)))
    vals = [tl.limbs_to_int(r) for r in x.numpy()]
    got = tr._pow2k(x, k)
    assert _values(got) == [pow(v, 2**k, P) for v in vals]
    # the values the loop over limb.sqr gave before the chain
    want = x
    for _ in range(k):
        want = tl.sqr(tl.FP, want)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [2, 5, 10])
def test_pow2k_matches_jax(k):
    """k = 2 unrolls in the JAX package, 5 and 10 take its fori_loop."""
    x = _rows(8, (6, tl.NLIMBS))
    want = np.asarray(jax.jit(lambda v: jr._pow2k(v, k))(x))
    got = tr._pow2k(torch.from_numpy(x), k)
    assert (_canon(want) == _canon(got)).all()


def test_pow_p58_and_invert_give_host_powers():
    x = torch.from_numpy(_rows(9, (4, tl.NLIMBS)))
    x[1] = torch.from_numpy(tl.int_to_limbs(1))
    vals = [tl.limbs_to_int(r) for r in x.numpy()]
    assert _values(tr.pow_p58(x)) == [pow(v, 2**252 - 3, P) for v in vals]
    inv = tr.invert(x)
    assert _values(inv) == [pow(v, P - 2, P) for v in vals]
    assert _values(tl.mul(tl.FP, inv, x)) == [1 if v % P else 0 for v in vals]


def test_decompress_gives_host_points():
    """Decompression (whose inverse square root is the chain's main caller on
    the verifier) against the host's decoder."""
    pts = _host_points(10, 5)
    enc = [jhost.ristretto_compress(p) for p in pts]
    s = torch.from_numpy(tl.limbs_from_bytes_le(
        np.frombuffer(b"".join(enc), dtype=np.uint8).reshape(-1, 32)))
    dec, valid = tr.decompress(s)
    assert valid.all()
    want = [jhost.ristretto_decompress(e) for e in enc]
    assert _affine(dec) == [p.affine() for p in want]
