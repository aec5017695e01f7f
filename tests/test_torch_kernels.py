"""The CUDA kernels (K1 mul_rows and its squaring chain, K3 add, K4 double
and its doubling chain, and the R-step scans madd_scan (K2 leaf), add_scan,
add_total) against their plain PyTorch versions.

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
@pytest.mark.parametrize("n", [64, 300], ids=["half-block", "ragged-blocks"])
@pytest.mark.parametrize("ctx", [limb.FP, limb.FL], ids=["fp", "fl"])
def test_mul_rows_kernel_matches_plain(cuda, ctx, n):
    a, b = _rows(1, (n, limb.NLIMBS)), _rows(2, (n, limb.NLIMBS))
    b[1] = 0
    want = limb.canon(ctx, fused.mul_rows_ref(ctx, a, b))
    key = f"mul_rows_{ctx.name}"
    before = fused.LAUNCHES[key]
    got = fused.mul_rows(ctx, a.to(cuda), b.to(cuda))
    torch.cuda.synchronize()
    assert fused.LAUNCHES[key] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("ctx", [limb.FP, limb.FL], ids=["fp", "fl"])
def test_mul_rows_kernel_squares_one_operand(cuda, ctx):
    """One tensor handed over twice takes the kernel's square path."""
    a = _rows(14, (3, 50, limb.NLIMBS))
    want = limb.canon(ctx, fused.mul_rows_ref(ctx, a, a))
    dev = a.to(cuda)
    assert torch.equal(fused.mul_rows(ctx, dev, dev).cpu(), want)
    assert torch.equal(limb.sqr(ctx, dev).cpu(), want)
    assert torch.equal(limb.sqr(ctx, dev[:, ::2]).cpu(), want[:, ::2])  # made contiguous first


@pytest.mark.cuda
@pytest.mark.parametrize("ctx", [limb.FP, limb.FL], ids=["fp", "fl"])
@pytest.mark.parametrize("shift", [1, 2, 3], ids=lambda s: f"rows-from-{s}")
def test_mul_rows_kernel_takes_any_int32_alignment(cuda, ctx, shift):
    """The alignment rule of the row kernels: a contiguous [n, 21] operand
    whose first word is not on a 16-byte boundary (a tensor sliced from row
    1, 2 or 3: 84, 168, 252 bytes in) is right, not refused; so is an output
    that lands on such an address."""
    n = 200
    a, b = _rows(15, (n + shift, limb.NLIMBS)), _rows(16, (n + shift, limb.NLIMBS))
    want = limb.canon(ctx, fused.mul_rows_ref(ctx, a[shift:], b[:n]))
    da, db = a.to(cuda)[shift:], b.to(cuda)[:n]
    assert da.data_ptr() % 16 and da.is_contiguous()
    assert torch.equal(fused.mul_rows(ctx, da, db).cpu(), want)
    assert torch.equal(fused.mul_rows(ctx, db, da).cpu(), want)
    want_sq = limb.canon(ctx, fused.mul_rows_ref(ctx, a[shift:], a[shift:]))
    assert torch.equal(fused.mul_rows(ctx, da, da).cpu(), want_sq)
    if ctx is limb.FP:
        want_chain = limb.canon(ctx, fused.sqr_chain_ref(ctx, a[shift:], 3))
        assert torch.equal(fused.sqr_chain(ctx, da, 3).cpu(), want_chain)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 50, 100])
def test_sqr_chain_kernel_matches_plain(cuda, k):
    x = _rows(17, (5, 41, limb.NLIMBS))
    x[0, 1] = 0
    x[0, 2] = torch.from_numpy(limb.int_to_limbs(1))
    want = limb.canon(limb.FP, fused.sqr_chain_ref(limb.FP, x, k))
    before = fused.LAUNCHES["sqr_chain"]
    got = fused.sqr_chain(limb.FP, x.to(cuda), k)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["sqr_chain"] == before + 1
    assert torch.equal(got.cpu(), want)


POINT_KERNELS = {
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
@pytest.mark.parametrize("n,windows,steps", [(41, 20, 13), (200, 3, 1), (5, 1, 13)],
                         ids=["verifier-shape", "steps-1", "one-window"])
def test_double_chain_kernel_matches_plain(cuda, n, windows, steps):
    p = _rows(18, (n, 4, limb.NLIMBS))
    p[1] = edwards.identity()
    want = limb.canon(limb.FP, fused.double_chain_ref(p, windows, steps))
    before = fused.LAUNCHES["double_chain"]
    got = fused.double_chain(p.to(cuda), windows, steps)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["double_chain"] == before + 1
    assert got.shape == (n, windows, 4, limb.NLIMBS)
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
    with pytest.raises(ValueError):
        fused.sqr_chain(limb.FL, a, 2)  # the chain kernel is mod p only
    with pytest.raises(ValueError):
        fused.sqr_chain(limb.FP, a, 0)
    p = _rows(6, (8, 4, limb.NLIMBS)).to(cuda)
    with pytest.raises(ValueError):
        fused.add(p, p.transpose(0, 1).contiguous().transpose(0, 1))  # not contiguous
    with pytest.raises(ValueError):
        fused.double_chain(p, 0, 13)
    shifted = torch.zeros(limb.NLIMBS + p.numel(), dtype=torch.int32, device=cuda)
    off_grid = shifted[limb.NLIMBS :].view(p.shape)
    with pytest.raises(ValueError):  # the point kernels read 16-byte vectors
        fused.add(p, off_grid)
    with pytest.raises(ValueError):
        fused.double(off_grid)
    with pytest.raises(ValueError):
        fused.double_chain(off_grid, 2, 13)


SCAN_KERNELS = {
    "madd_scan": (fused.madd_scan, fused.madd_scan_ref, edwards.identity_niels),
    "add_scan": (fused.add_scan, fused.add_scan_ref, edwards.identity),
    "add_total": (fused.add_total, fused.add_total_ref, edwards.identity),
}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [32, 1])
@pytest.mark.parametrize("name", list(SCAN_KERNELS))
def test_scan_kernel_matches_plain(cuda, name, R):
    """A leading batch of 3, a ragged block count (5 blocks: the thread grid
    is not full), identity items and an all-8192 item."""
    kern, ref, ident = SCAN_KERNELS[name]
    items = _rows(11, (3, 5 * R, 4, limb.NLIMBS))
    items[1, : min(R, 7)] = ident()  # a block that starts with identities
    items[2, -1] = ident()
    want = [limb.canon(limb.FP, t) for t in _as_tuple(ref(items, R))]
    before = fused.LAUNCHES[name]
    got = _as_tuple(kern(items.to(cuda), R))
    torch.cuda.synchronize()
    assert fused.LAUNCHES[name] == before + 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    if name != "add_total":  # totals are the last prefix of every block
        within, totals = got
        assert torch.equal(within[:, R - 1 :: R], totals)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCAN_KERNELS))
def test_scan_wrappers_raise_on_what_the_kernel_does_not_take(cuda, name):
    kern = SCAN_KERNELS[name][0]
    items = _rows(12, (2, 64, 4, limb.NLIMBS)).to(cuda)
    before = fused.LAUNCHES[name]
    with pytest.raises(ValueError):
        kern(items[:, :63], 32)  # not C*R items (and not contiguous)
    with pytest.raises(ValueError):
        kern(items[:, :63].contiguous(), 32)  # contiguous, still not C*R items
    with pytest.raises(ValueError):
        kern(items.repeat(1, 1, 1, 2)[..., ::2], 32)  # right shape, not contiguous
    with pytest.raises(TypeError):
        kern(items.long(), 32)
    with pytest.raises(ValueError):
        kern(items[..., :20].contiguous(), 32)  # not [..., 4, 21] rows
    shifted = torch.zeros(limb.NLIMBS + items.numel(), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # contiguous, but one 84-byte row off the 16-byte grid
        kern(shifted[limb.NLIMBS :].view(items.shape), 32)
    assert fused.LAUNCHES[name] == before


def test_cpu_tensors_take_the_plain_versions():
    a, b = _rows(7, (16, limb.NLIMBS)), _rows(8, (16, limb.NLIMBS))
    p, q = _rows(9, (5, 4, limb.NLIMBS)), _rows(10, (5, 4, limb.NLIMBS))
    before = fused.launch_counts()
    assert torch.equal(fused.mul_rows(limb.FL, a, b), fused.mul_rows_ref(limb.FL, a, b))
    assert torch.equal(fused.add(p, q), fused.add_ref(p, q))
    assert torch.equal(fused.double(p), fused.double_ref(p))
    assert torch.equal(fused.double_chain(p, 3, 2), fused.double_chain_ref(p, 3, 2))
    assert torch.equal(fused.sqr_chain(limb.FP, a, 3), fused.sqr_chain_ref(limb.FP, a, 3))
    assert torch.equal(fused.madd_scan(p[:4], 2)[1], fused.madd_scan_ref(p[:4], 2)[1])
    items = _rows(13, (2, 12, 4, limb.NLIMBS))
    for name, (kern, ref, _) in SCAN_KERNELS.items():
        for g, w in zip(_as_tuple(kern(items, 4)), _as_tuple(ref(items, 4))):
            assert torch.equal(g, w), name
    with pytest.raises(ValueError):
        fused.add_total(items, 5)  # 12 items are not whole blocks of 5
    assert fused.launch_counts() == before
    ops = fused.kernel_operands(a, b)
    assert ops[0] is a and ops[1] is b
