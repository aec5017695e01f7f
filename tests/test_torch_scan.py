"""The R-step block scans of the port (`fused.madd_scan`, `add_scan`,
`add_total` and the `ops/msm.py` functions routed through them) against the
stepwise `madd_ref` / `add_ref` loop and against the JAX package's
`_bucket_scan_rows`, `_inclusive_scan_points` and `_tree_sum_points`.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
to the same plain versions in tests/test_torch_kernels.py.  Inputs are
numpy-seeded rows with limbs in [0, 8192] (an all-8192 row and identity
items included): the point formulas are polynomial identities mod p, so both
packages must agree on any rows, not only on curve points.  Everything is
compared after canonicalisation, tolerance 0 (integers): equal bytes mean
the additions ran in the same order.
"""

import jax
import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu.ops import msm as jm
from dusk_blindbidproof_tpu_torch.ops import edwards as te
from dusk_blindbidproof_tpu_torch.ops import fused as tf
from dusk_blindbidproof_tpu_torch.ops import limb as tl
from dusk_blindbidproof_tpu_torch.ops import msm as tm

# small tensors: one intra-op thread each, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _items(seed: int, shape, niels: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 8193, size=(*shape, 4, tl.NLIMBS), dtype=np.int32)
    flat = x.reshape(-1, 4, tl.NLIMBS)
    flat[0] = 8192  # max-bound rows
    ident = (te.identity_niels if niels else te.identity)().numpy()
    flat[1] = ident
    flat[-3:] = ident
    return x


def _canon(x) -> np.ndarray:
    return tl.canon(tl.FP, torch.from_numpy(np.array(x))).numpy()


def _stepwise(step, items: torch.Tensor, R: int):
    """The loop the scans replace, item by item and block by block."""
    batch, m = items.shape[:-3], items.shape[-3]
    within = torch.empty_like(items)
    totals = []
    for c in range(m // R):
        acc = te.identity().expand(*batch, 4, tl.NLIMBS)
        for r in range(R):
            acc = step(acc, items[..., c * R + r, :, :])
            within[..., c * R + r, :, :] = acc
        totals.append(acc)
    return within, torch.stack(totals, dim=-3)


SCANS = {
    "madd_scan": (tf.madd_scan, tf.madd_scan_ref, tf.madd_ref, True),
    "add_scan": (tf.add_scan, tf.add_scan_ref, tf.add_ref, False),
    "add_total": (tf.add_total, tf.add_total_ref, tf.add_ref, False),
}


@pytest.mark.parametrize("R", [32, 4, 1])
@pytest.mark.parametrize("name", list(SCANS))
def test_scan_matches_stepwise_loop(name, R):
    wrapper, ref, step, niels = SCANS[name]
    items = torch.from_numpy(_items(1, (2, 3 * R), niels))
    within, totals = _stepwise(step, items, R)
    got = ref(items, R)
    if name == "add_total":
        assert torch.equal(got, totals)
        assert torch.equal(wrapper(items, R), totals)
    else:
        assert torch.equal(got[0], within) and torch.equal(got[1], totals)
        routed = wrapper(items, R)
        assert torch.equal(routed[0], within) and torch.equal(routed[1], totals)
        assert torch.equal(within[..., R - 1 :: R, :, :], totals)


@pytest.mark.parametrize("name", list(SCANS))
def test_scan_refuses_partial_blocks(name):
    wrapper, ref, _, niels = SCANS[name]
    items = torch.from_numpy(_items(2, (10,), niels))
    with pytest.raises(ValueError):
        ref(items, 4)
    with pytest.raises(ValueError):
        wrapper(items, 4)


@pytest.mark.parametrize("niels", [True, False], ids=["niels", "extended"])
def test_bucket_scan_rows_matches_jax(niels):
    """Ragged m = 200 (7 blocks of 32, 24 padded items) under a batch of 2."""
    x = _items(3, (2, 200), niels)
    j_within, j_offsets = jax.jit(lambda a: jm._bucket_scan_rows(a, niels)[:2])(x)
    within, offsets, r = tm._bucket_scan_rows(torch.from_numpy(x), niels)
    assert r == jm._BLOCK_R == 32
    assert within.shape == (2, 224, 4, tl.NLIMBS)
    assert (_canon(j_within) == _canon(within)).all()
    assert (_canon(j_offsets) == _canon(offsets)).all()


def test_inclusive_scan_points_matches_jax():
    """m = 200 takes the blocked branch (above _UNROLL_MAX = 128), then the
    ladder on its 7 block totals."""
    x = _items(4, (2, 200), False)
    want = jax.jit(jm._inclusive_scan_points)(x)
    got = tm._inclusive_scan_points(torch.from_numpy(x))
    assert got.shape == (2, 200, 4, tl.NLIMBS)
    assert (_canon(want) == _canon(got)).all()


def test_tree_sum_points_matches_jax(monkeypatch):
    """m = 200 through the blocked branch: both packages' halving bound is
    lowered from 512 to 16 so that a small input reaches it, and the 7 block
    totals then halve with an odd tail."""
    monkeypatch.setattr(jm, "_TREE_UNROLL_MAX", 16)
    monkeypatch.setattr(tm, "_TREE_UNROLL_MAX", 16)
    x = _items(5, (2, 200), False)
    want = jax.jit(jm._tree_sum_points)(x)
    got = tm._tree_sum_points(torch.from_numpy(x))
    assert got.shape == (2, 4, tl.NLIMBS)
    assert (_canon(want) == _canon(got)).all()
