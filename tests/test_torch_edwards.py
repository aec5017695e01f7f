"""Edwards point ops of the port against the JAX package (the point kernels
K2-K4 are held to these plain versions in tests/test_torch_kernels.py).

The JAX side runs `edwards.add_impl / add_niels / double_impl` and, for the
batched identity case, `fused.add_rows`, which on the CPU runs the Pallas
kernel in interpret mode as tests/test_fused.py does.  Points are compared
on canonical coordinates.
"""

import jax
import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu.ops import edwards as je
from dusk_blindbidproof_tpu.ops import fused as jf
from dusk_blindbidproof_tpu_torch.ops import edwards as te
from dusk_blindbidproof_tpu_torch.ops import fused as tf
from dusk_blindbidproof_tpu_torch.ops import limb as tl
from dusk_blindbidproof_tpu_torch.utils import curve_host as host

# small tensors: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

M = 300


def _rows(seed: int, shape):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 8193, size=(*shape, 4, tl.NLIMBS), dtype=np.int32)
    p.reshape(-1, 4, tl.NLIMBS)[0] = 8192  # max-bound row
    return p


def _canon_np(x) -> np.ndarray:
    return tl.canon(tl.FP, torch.from_numpy(np.array(x))).numpy()


OPS = {
    "add": (lambda p, q: je.add_impl(p, q), te.add_impl, 2),
    "madd": (lambda p, q: je.add_niels(p, q), te.add_niels_impl, 2),
    "double": (lambda p: je.double_impl(p), te.double_impl, 1),
}


@pytest.mark.parametrize("name", list(OPS))
def test_point_ops_match_jax(name):
    jfn, tfn, n_in = OPS[name]
    args = [_rows(10 + i, (M,)) for i in range(n_in)]
    want = np.asarray(jax.jit(jfn)(*args))
    got = tfn(*[torch.from_numpy(a) for a in args])
    assert (_canon_np(want) == _canon_np(got)).all()


def test_batched_identity_matches_fused_interpret():
    """(3, 40) batch against identity rows, the MSM's padding values."""
    p = _rows(20, (3, 40))
    q = np.broadcast_to(np.asarray(je.identity()), p.shape)
    want = np.asarray(jax.jit(lambda a, b: jf.add_rows(a, b))(p, q))
    got = te.add(torch.from_numpy(p), te.identity(device="cpu"))
    assert (_canon_np(want) == _canon_np(got)).all()
    # adding the identity leaves the point unchanged (projectively)
    assert te.eq_points(got, torch.from_numpy(p)).all()


def test_host_points_roundtrip_and_group_law():
    B = host.ED25519_BASEPOINT
    pts = [B.scalar_mul(k) for k in (1, 2, 3, 7)]
    dev = te.from_host(pts)
    assert te.on_curve(dev).all()
    assert te.to_host(te.double(dev[:1]))[0].affine() == pts[1].affine()
    assert te.to_host(te.add(dev[1:2], dev[:1]))[0].affine() == pts[2].affine()
    niels = te.to_niels(dev[:1])
    assert te.to_host(tf.madd_ref(dev[1:2], niels))[0].affine() == pts[2].affine()
    # the same mixed add as the last step of a two-item bucket scan
    ident = te.to_niels(te.identity((1,)))
    within, totals = tf.madd_scan(torch.cat([te.to_niels(dev[1:2]), niels]), 2)
    assert te.to_host(totals)[0].affine() == pts[2].affine()
    assert te.to_host(within[:1])[0].affine() == pts[1].affine()
    assert te.eq_points(tf.madd_ref(dev, ident), dev).all()
    assert te.eq_points(te.add(dev, te.negate(dev)), te.identity((4,))).all()


def test_scalar_mul_bits_matches_host():
    B = host.ED25519_BASEPOINT
    k = 0xC0FFEE123456789
    s = torch.from_numpy(tl.int_to_limbs(k))
    bits = te.scalar_limbs_to_bits(s, nbits=64)
    got = te.scalar_mul_bits(te.from_host(B), bits)
    assert te.to_host(got)[0].affine() == B.scalar_mul(k).affine()
