"""The four CUDA kernels (K1 mul_rows, K2 madd, K3 add, K4 double) against
their plain PyTorch versions.

This file imports neither jax nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest tests/test_torch_kernels.py

The kernel tests need a card (marker `cuda`) and skip without one.  The
kernels return canonical limbs, so each is held to `canon(plain)` exactly,
on random rows, all-8192 rows (the largest input the plain engine hands
over, limb 20 included) and identity points.
"""

import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb

# small tensors: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _rows(seed: int, shape) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 8193, size=shape, dtype=np.int32)
    x.reshape(-1, shape[-1])[0] = 8192
    return torch.from_numpy(x)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("ctx", [limb.FP, limb.FL], ids=["fp", "fl"])
def test_mul_rows_kernel_matches_plain(cuda, ctx):
    a, b = _rows(1, (64, limb.NLIMBS)), _rows(2, (64, limb.NLIMBS))
    b[1] = 0
    want = limb.canon(ctx, fused.mul_rows_ref(ctx, a, b))
    key = f"mul_rows_{ctx.name}"
    before = fused.LAUNCHES[key]
    got = fused.mul_rows(ctx, a.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 1
    assert torch.equal(got.cpu(), want)


POINT_KERNELS = {
    "madd": (fused.madd, fused.madd_ref, edwards.identity_niels),
    "add": (fused.add, fused.add_ref, edwards.identity),
    "double": (fused.double, fused.double_ref, edwards.identity),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(POINT_KERNELS))
def test_point_kernel_matches_plain(cuda, name):
    kern, ref, ident = POINT_KERNELS[name]
    shape = (3, 40, 4, limb.NLIMBS)
    args = [_rows(3, shape)] if name == "double" else [_rows(3, shape), _rows(4, shape)]
    args[-1][0] = ident()  # a whole batch row of identity points
    want = limb.canon(limb.FP, ref(*args))
    before = fused.LAUNCHES[name]
    got = kern(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert fused.LAUNCHES[name] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    a = _rows(5, (8, limb.NLIMBS)).to(cuda)
    with pytest.raises(ValueError):
        fused.mul_rows(limb.FP, a, a[:4])  # shapes differ: the caller broadcasts
    with pytest.raises(ValueError):
        fused.mul_rows(limb.FP, a, a.cpu())  # mixed devices
    with pytest.raises(TypeError):
        fused.mul_rows(limb.FP, a, a.long())
    p = _rows(6, (8, 4, limb.NLIMBS)).to(cuda)
    with pytest.raises(ValueError):
        fused.add(p, p.transpose(0, 1).contiguous().transpose(0, 1))  # not contiguous


def test_cpu_tensors_take_the_plain_versions():
    a, b = _rows(7, (16, limb.NLIMBS)), _rows(8, (16, limb.NLIMBS))
    p, q = _rows(9, (5, 4, limb.NLIMBS)), _rows(10, (5, 4, limb.NLIMBS))
    before = fused.launch_counts()
    assert torch.equal(fused.mul_rows(limb.FL, a, b), fused.mul_rows_ref(limb.FL, a, b))
    assert torch.equal(fused.add(p, q), fused.add_ref(p, q))
    assert torch.equal(fused.madd(p, q), fused.madd_ref(p, q))
    assert torch.equal(fused.double(p), fused.double_ref(p))
    assert fused.launch_counts() == before
    ops = fused.kernel_operands(a, b)
    assert ops[0] is a and ops[1] is b
