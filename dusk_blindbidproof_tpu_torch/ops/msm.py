"""Multi-scalar multiplication (MSM) on tensors.

Design (scatter-free Pippenger, as in the JAX package):

  * Window size c = 13 = LIMB_BITS, so the canonical limb decomposition of
    a scalar IS its window-digit decomposition.
  * Fixed bases are pre-scaled per window: table[i, w] = 2^(13 w) * G_i,
    with an affine-Niels copy (Z=1) for 7M mixed scan adds.  An MSM then is
    one flat weighted sum  sum_j digit_j * Q_j  over m = n * WINDOWS items.
  * Bucket accumulation: sort items by digit descending (stable), gather
    the point rows, run R = 32 step within-block inclusive scans over all
    blocks at once (one scan-kernel launch for all R steps), take block
    offsets from a recursive scan of the block totals, and read the scan only at the
    bucket boundaries located by a digit histogram: suf_k = sum of items
    with digit >= k.  Then sum_b b * B_b = sum_{k>=1} suf_k, one tree sum.

A leading batch axis runs independent MSMs (independent proofs) in
lockstep.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import edwards, fused, limb
from .limb import FL, LIMB_BITS, NLIMBS

# Canonical scalars are < L < 2^253, so limb 20 (weight 2^260) is always
# zero — 20 windows suffice.
WINDOWS = NLIMBS - 1
D_BUCKETS = 1 << LIMB_BITS

# below this item count a Hillis-Steele ladder replaces the blocked scan
_UNROLL_MAX = 128
# sequential block length of the two-level scans: R scan steps of width m/R
_BLOCK_R = 32
# below this item count the tree sum halves directly
_TREE_UNROLL_MAX = 512
# at or below this item count (and for extended, non-Niels points) the MSM
# takes the bit-plane path: the verifier's ~800-item dynamic MSM
BIT_MSM_MAX_ITEMS = 1024


def prescale_windows(points: torch.Tensor) -> torch.Tensor:
    """[n, 4, NLIMBS] points -> [n, WINDOWS, 4, NLIMBS] with
    out[i, w] = 2^(13 w) * P_i, computed by 13 batched doubles per window."""
    scaled = [points]
    for _ in range(WINDOWS - 1):
        nxt = scaled[-1]
        for _ in range(LIMB_BITS):
            nxt = edwards.double(nxt)
        scaled.append(nxt)
    return torch.stack(scaled, dim=-3)


def _shift_down(x: torch.Tensor, k: int, fill: torch.Tensor) -> torch.Tensor:
    """x[..., j, :, :] -> x[..., j-k, :, :] along dim -3 (items), filling
    with `fill` rows at the front."""
    pad = fill.expand(*x.shape[:-3], k, *x.shape[-2:])
    return torch.cat([pad, x[..., :-k, :, :]], dim=-3)


def _pad_items(x: torch.Tensor, k: int, niels: bool = False) -> torch.Tensor:
    ident = (edwards.identity_niels if niels else edwards.identity)(device=x.device)
    pad = ident.expand(*x.shape[:-3], k, *x.shape[-2:])
    return torch.cat([x, pad], dim=-3)


def _blocked(x: torch.Tensor, niels: bool = False):
    """[..., m, 4, NL] -> ([..., C*R, 4, NL] contiguous, C) with identity
    padding, the layout the scan kernels take; block c holds items
    [c*R, (c+1)*R)."""
    m = x.shape[-3]
    C = -(-m // _BLOCK_R)
    if C * _BLOCK_R != m:
        x = _pad_items(x, C * _BLOCK_R - m, niels=niels)
    return x.contiguous(), C


def _inclusive_scan_points(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix scan of points along dim -3.

    Two-level blocked scan: R = 32 sequential steps run all m/R blocks'
    local scans in lockstep, block offsets come from recursing on the m/R
    block totals, and one broadcast add applies them.  Small m runs a
    Hillis-Steele ladder instead."""
    m = x.shape[-3]
    ident = edwards.identity(device=x.device)
    if m == 1:
        return x
    if m <= _UNROLL_MAX:
        off = 1
        while off < m:
            x = edwards.add(x, _shift_down(x, off, ident))
            off *= 2
        return x
    xs, C = _blocked(x)
    within, totals = fused.add_scan(xs, _BLOCK_R)
    offsets = _shift_down(_inclusive_scan_points(totals), 1, ident)  # exclusive
    out = within.reshape(*within.shape[:-3], C, _BLOCK_R, 4, NLIMBS)
    out = edwards.add(out, offsets[..., :, None, :, :])
    out = out.reshape(*out.shape[:-4], C * _BLOCK_R, 4, NLIMBS)
    return out[..., :m, :, :]


def _tree_sum_points(x: torch.Tensor) -> torch.Tensor:
    """Sum points along dim -3 (any length): R-step block accumulation for
    large m, then recursive halving."""
    m = x.shape[-3]
    if m == 1:
        return x[..., 0, :, :]
    if m <= _TREE_UNROLL_MAX:
        while m > 1:
            half = x[..., : m - m % 2, :, :].reshape(
                *x.shape[:-3], m // 2, 2, 4, NLIMBS
            )
            summed = edwards.add(half[..., 0, :, :], half[..., 1, :, :])
            if m % 2:
                summed = torch.cat([summed, x[..., m - 1 :, :, :]], dim=-3)
            x = summed
            m = x.shape[-3]
        return x[..., 0, :, :]
    xs, _ = _blocked(x)
    return _tree_sum_points(fused.add_total(xs, _BLOCK_R))


def _bit_msm(points: torch.Tensor, digits: torch.Tensor) -> torch.Tensor:
    """Small-m weighted sum via digit bit-planes: 13 masked tree sums
    (batched over the bit axis) + a 12-step Horner combine."""
    nbits = LIMB_BITS
    shifts = torch.arange(nbits, dtype=torch.int32, device=digits.device)
    bits = (digits[..., :, None] >> shifts) & 1  # [..., m, nbits]
    bits = bits.movedim(-1, -2)  # [..., nbits, m]
    pts = points[..., None, :, :, :]  # [..., 1, m, 4, NL]
    masked = edwards.select(
        bits != 0, pts, edwards.identity(device=points.device)
    )
    t = _tree_sum_points(masked)  # [..., nbits, 4, NLIMBS]
    acc = t[..., nbits - 1, :, :]
    for j in range(nbits - 2, -1, -1):
        acc = edwards.add(edwards.double(acc), t[..., j, :, :])
    return acc


def bucket_msm(
    points: torch.Tensor,
    digits: torch.Tensor,
    niels: bool = False,
    d_max: int = D_BUCKETS,
) -> torch.Tensor:
    """sum_j digits[j] * points[j] with digits in [0, d_max).

    points: [..., m, 4, NLIMBS] (leading dims broadcast against digits'),
    digits: [..., m] int32.  With niels=True the points are affine-Niels
    rows and every scan leaf add is the 7M mixed formula (K2).  Returns
    [..., 4, NLIMBS].
    """
    if points.shape[-3] <= BIT_MSM_MAX_ITEMS and not niels:
        assert d_max <= D_BUCKETS, "bit path needs canonical 13-bit digits"
        return _bit_msm(points, digits)
    batch = torch.broadcast_shapes(points.shape[:-3], digits.shape[:-1])
    points = points.expand(*batch, *points.shape[-3:])
    digits = digits.expand(*batch, digits.shape[-1])
    order = torch.sort(digits, dim=-1, descending=True, stable=True).indices
    d_sorted = torch.gather(digits, -1, order)
    pts_sorted = torch.take_along_dim(points, order[..., None, None], dim=-3)

    # histogram of digits -> count_ge[k] = #items with digit >= k
    hist = _batched_hist(d_sorted, d_max)  # [..., d_max]
    suffix_counts = hist.flip(-1).cumsum(-1).flip(-1)
    pos = suffix_counts - 1  # last sorted index with digit >= k (desc order)

    within_f, offsets, R = _bucket_scan_rows(pts_sorted, niels)

    # suf_k = scan[pos_k] for k >= 1, identity when no item has digit >= k
    pos_k = pos[..., 1:]
    valid = pos_k >= 0
    safe_pos = pos_k.clamp(min=0)
    vals = torch.take_along_dim(within_f, safe_pos[..., None, None], dim=-3)
    offs = torch.take_along_dim(
        offsets, (safe_pos // R)[..., None, None], dim=-3
    )
    suf = edwards.add(vals, offs)
    suf = edwards.select(valid, suf, edwards.identity(device=points.device))
    return _tree_sum_points(suf)


def _bucket_scan_rows(pts_sorted: torch.Tensor, niels: bool):
    """Within-block inclusive scans + exclusive block offsets.

    Returns (within_f [..., C*R, 4, NL] in item order: within_f[p] = sum of
    items (p//R)*R .. p, offsets [..., C, 4, NL], R)."""
    xs, _ = _blocked(pts_sorted, niels=niels)
    ident = edwards.identity(device=pts_sorted.device)
    scan = fused.madd_scan if niels else fused.add_scan
    within_f, totals = scan(xs, _BLOCK_R)
    offsets = _shift_down(_inclusive_scan_points(totals), 1, ident)
    return within_f, offsets, _BLOCK_R


def _batched_hist(d_sorted: torch.Tensor, d_max: int = D_BUCKETS) -> torch.Tensor:
    """Histogram over the last dim for arbitrary leading batch dims."""
    flat = d_sorted.reshape(-1, d_sorted.shape[-1]).long()
    hist = torch.zeros(
        (flat.shape[0], d_max), dtype=torch.int32, device=d_sorted.device
    )
    hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))
    return hist.reshape(*d_sorted.shape[:-1], d_max)


def msm(points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """General MSM: sum_i scalars[i] * points[i].

    points: [..., n, 4, NLIMBS]; scalars: [..., n, NLIMBS] working form.
    Pre-scales windows on the fly (13*(WINDOWS-1) batched doubles, K4),
    then runs the flat bucket accumulation over m = n * WINDOWS items.
    """
    digits = limb.canon(FL, scalars)  # [..., n, NLIMBS]; limbs ARE digits
    batch, n = points.shape[:-3], points.shape[-3]
    table = prescale_windows(points.reshape(-1, 4, NLIMBS))
    return msm_prescaled(table.reshape(*batch, n, WINDOWS, 4, NLIMBS), digits)


def msm_prescaled(
    table: torch.Tensor,
    digits: torch.Tensor,
    niels: bool = False,
    d_max: int = D_BUCKETS,
) -> torch.Tensor:
    """MSM against a pre-scaled window table.

    table: [..., n, WINDOWS, 4, NLIMBS] (leading dims broadcast against
    digits'; affine-Niels rows when niels=True); digits: [..., n, WINDOWS or
    NLIMBS] window digits < d_max (canonical limbs).
    """
    n = table.shape[-4]
    if digits.shape[-1] != WINDOWS:  # canonical limbs: drop the zero slack
        digits = digits[..., :WINDOWS]
    flat_pts = table.reshape(*table.shape[:-4], n * WINDOWS, 4, NLIMBS)
    flat_digits = digits.reshape(*digits.shape[:-2], n * WINDOWS)
    return bucket_msm(flat_pts, flat_digits, niels=niels, d_max=d_max)


# ---------------------------------------------------------------------------
# Fixed-base generator tables (built on the device once per capacity)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def _host_points(gens_capacity: int):
    from ..utils.generators import PedersenGens, cached_bp_gens

    bp = cached_bp_gens(gens_capacity)
    pc = PedersenGens.default()
    return bp.G_vec[0] + bp.H_vec[0] + [pc.B, pc.B_blinding]


def table_layout(gens_capacity: int) -> dict:
    """Row ranges of the tables: G | H | B | B_blinding."""
    return {
        "G": (0, gens_capacity),
        "H": (gens_capacity, 2 * gens_capacity),
        "B": 2 * gens_capacity,
        "B_blinding": 2 * gens_capacity + 1,
    }


@functools.lru_cache(maxsize=4)
def pedersen_tables(gens_capacity: int, device: torch.device):
    """Pre-scaled tables for (G_vec ++ H_vec ++ B ++ B_blinding) on `device`:
    ([2cap+2, WINDOWS, 4, NLIMBS] table, layout)."""
    dev_pts = edwards.from_host(_host_points(gens_capacity), device=device)
    return prescale_windows(dev_pts), table_layout(gens_capacity)


@functools.lru_cache(maxsize=4)
def pedersen_tables_niels(gens_capacity: int, device: torch.device):
    """Affine-Niels form of pedersen_tables (rows y-x, y+x, 2d*xy, 0):
    pre-normalized so the bucket-MSM scan uses 7M mixed adds."""
    table, layout = pedersen_tables(gens_capacity, device)
    niels = edwards.to_niels(table.reshape(-1, 4, NLIMBS))
    return niels.reshape(table.shape), layout


def tables_from_reference(table_np: np.ndarray, niels_np: np.ndarray, device):
    """The JAX package's pedersen_tables(cap) / pedersen_tables_niels(cap)
    numpy arrays -> this package's (table, niels) tensors on `device`."""
    def one(a):
        a = np.ascontiguousarray(a, dtype=np.int32)
        assert a.ndim == 4 and a.shape[1:] == (WINDOWS, 4, NLIMBS), a.shape
        return torch.from_numpy(a.copy()).to(device)

    return one(table_np), one(niels_np)
