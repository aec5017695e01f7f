"""The PyTorch limb engine against the JAX package's.

Inputs are drawn with numpy from a seed and handed to both packages.  The
plain path is bit-exact with the JAX engine: the same bound-tracked stages
run on both sides.  The modular-product kernel (K1) is held to this plain
path in tests/test_torch_kernels.py.
"""

import jax
import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu.ops import limb as jl
from dusk_blindbidproof_tpu_torch.ops import limb as tl

# small tensors: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

CTXS = [(jl.FP, tl.FP), (jl.FL, tl.FL)]
IDS = ["fp", "fl"]
N = 64


def _pair(seed: int, hi: int = 8193):
    """Two [N, 21] limb arrays with limbs in [0, hi); row 0 is all-8192
    (the max-bound input, limb 20 included), row 1 all-8191."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, hi, size=(N, tl.NLIMBS), dtype=np.int32)
    b = rng.integers(0, hi, size=(N, tl.NLIMBS), dtype=np.int32)
    a[0] = b[0] = 8192
    a[1] = b[1] = 8191
    return a, b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("ctxs", CTXS, ids=IDS)
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_bit_exact(ctxs, op):
    cj, ct = ctxs
    a, b = _pair(1)
    want = np.asarray(getattr(jl, "j" + op)(cj, a, b))
    got = getattr(tl, op)(ct, _t(a), _t(b)).numpy()
    assert (want == got).all()


@pytest.mark.parametrize("ctxs", CTXS, ids=IDS)
def test_unary_ops_bit_exact(ctxs):
    cj, ct = ctxs
    a, _ = _pair(2)
    A = _t(a)
    assert (np.asarray(jl.jsqr(cj, a)) == tl.sqr(ct, A).numpy()).all()
    assert (np.asarray(jl.jneg(cj, a)) == tl.neg(ct, A).numpy()).all()
    assert (np.asarray(jl.jcanon(cj, a)) == tl.canon(ct, A).numpy()).all()
    assert (np.asarray(jl.jis_zero(cj, a)) == tl.is_zero(ct, A).numpy()).all()
    small = np.asarray(jax.jit(lambda x: jl.mul_small(cj, x, 8191))(a))
    assert (small == tl.mul_small(ct, A, 8191).numpy()).all()


@pytest.mark.parametrize("ctxs", CTXS, ids=IDS)
def test_add_many_and_zero(ctxs):
    cj, ct = ctxs
    a, b = _pair(3)
    terms = np.stack([a, b, a])  # [3, N, 21], summed over dim 0
    want = np.asarray(jl.jadd_many(cj, terms, 0))
    got = tl.add_many(ct, _t(terms), 0)
    assert got.dtype == torch.int32
    assert (want == got.numpy()).all()
    # value M in limbs is zero mod M
    m = np.stack([jl.int_to_limbs(cj.modulus), jl.int_to_limbs(0)])
    assert tl.is_zero(ct, _t(m)).tolist() == [True, True]


@pytest.mark.parametrize("ctxs", CTXS, ids=IDS)
def test_values_against_python_ints(ctxs):
    _, ct = ctxs
    a, b = _pair(4)
    M = ct.modulus
    got = tl.limbs_to_ints(tl.canon(ct, tl.mul(ct, _t(a), _t(b))))
    want = [x * y % M for x, y in zip(tl.limbs_to_ints(a), tl.limbs_to_ints(b))]
    assert got == want


def test_byte_conversions_roundtrip():
    rng = np.random.default_rng(5)
    vals = [int.from_bytes(rng.bytes(32), "little") >> 1 for _ in range(16)]
    limbs = tl.ints_to_limbs_fast(vals)
    assert (limbs == jl.ints_to_limbs_fast(vals)).all()
    assert tl.limbs_to_ints(limbs) == vals
    back = tl.limbs_to_bytes_le(limbs)
    assert [int.from_bytes(r.tobytes(), "little") for r in back] == vals
