"""Batched Edwards point arithmetic on tensors (extended coordinates).

A point batch is one int32 tensor of shape [..., 4, NLIMBS] holding
(X, Y, Z, T) in extended coordinates over F_p as 13-bit limbs — a flat
layout so MSM gathers, sorts and selects move whole points as rows.

Formulas (complete on a = -1 with d non-square, so the unified add is safe
for P+P, identity and mixed inputs, as the MSM scan's data-dependent
combines require):
  * add:    add-2008-hwcd-3 (9M)
  * madd:   madd-2008-hwcd-3 against affine-Niels rows (7M)
  * double: dbl-2008-hwcd (4M + 4S)

`add` and `double` launch the hand-written kernels (ops.fused) for CUDA
tensors and run their plain versions for CPU tensors.  The mixed add is
the leaf of the bucket scan `fused.madd_scan`; `add_niels_impl` is its plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import curve_host as host
from . import fused, limb
from .limb import FP, NLIMBS

# 2*d mod p as limbs, for the hwcd-3 addition
D2_LIMBS = limb.int_to_limbs(2 * host.D % host.P)
_ONE = limb.int_to_limbs(1)

add_impl = fused.add_ref
add_niels_impl = fused.madd_ref
double_impl = fused.double_ref


def identity(batch_shape: tuple[int, ...] = (), device="cpu") -> torch.Tensor:
    pt = np.zeros((*batch_shape, 4, NLIMBS), dtype=np.int32)
    pt[..., 1, :] = _ONE  # Y = 1
    pt[..., 2, :] = _ONE  # Z = 1
    return torch.from_numpy(pt).to(device)


def identity_niels(batch_shape: tuple[int, ...] = (), device="cpu") -> torch.Tensor:
    """Identity in affine-Niels form: (y-x, y+x, 2d*t) = (1, 1, 0)."""
    pt = np.zeros((*batch_shape, 4, NLIMBS), dtype=np.int32)
    pt[..., 0, :] = _ONE
    pt[..., 1, :] = _ONE
    return torch.from_numpy(pt).to(device)


def from_host(points, device="cpu") -> torch.Tensor:
    """host EdwardsPoint or list thereof -> [..., 4, NLIMBS] limbs."""
    squeeze = isinstance(points, host.EdwardsPoint)
    if squeeze:
        points = [points]
    arr = np.stack(
        [
            np.stack(
                [
                    limb.int_to_limbs(p.X % host.P),
                    limb.int_to_limbs(p.Y % host.P),
                    limb.int_to_limbs(p.Z % host.P),
                    limb.int_to_limbs(p.T % host.P),
                ]
            )
            for p in points
        ]
    )
    return torch.from_numpy(arr[0] if squeeze else arr).to(device)


def to_host(pts: torch.Tensor) -> list[host.EdwardsPoint]:
    """[..., 4, NLIMBS] -> list of host EdwardsPoints (canonicalized)."""
    arr = limb.canon(FP, pts).cpu().numpy()
    return [
        host.EdwardsPoint(*[limb.limbs_to_int(c) for c in row])
        for row in arr.reshape(-1, 4, NLIMBS)
    ]


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Unified extended addition (K3 on CUDA)."""
    return fused.add(*fused.kernel_operands(p, q))


def double(p: torch.Tensor) -> torch.Tensor:
    """Doubling (K4 on CUDA)."""
    return fused.double(*fused.kernel_operands(p))


def to_niels(p: torch.Tensor) -> torch.Tensor:
    """Extended [..., 4, NLIMBS] -> affine-Niels rows (y-x, y+x, 2d*xy, 0).

    Normalizes Z to 1 with a batched Fermat inversion chain (one-time table
    preparation; the payoff is the 7M mixed add in the MSM scans)."""
    from . import ristretto

    zinv = ristretto.invert(p[..., 2, :])
    x = limb.mul(FP, p[..., 0, :], zinv)
    y = limb.mul(FP, p[..., 1, :], zinv)
    t2d = limb.mul(FP, limb.const(D2_LIMBS, p.device), limb.mul(FP, x, y))
    return torch.stack(
        [limb.sub(FP, y, x), limb.add(FP, y, x), t2d, torch.zeros_like(x)],
        dim=-2,
    )


def negate(p: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            limb.neg(FP, p[..., 0, :]),
            p[..., 1, :],
            p[..., 2, :],
            limb.neg(FP, p[..., 3, :]),
        ],
        dim=-2,
    )


def select(cond: torch.Tensor, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """cond ? p : q, cond shaped [...] against [..., 4, NLIMBS] points."""
    return torch.where(cond[..., None, None], p, q)


def scalar_mul_bits(p: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Variable-base scalar multiplication by a scalar given as a bit tensor
    [..., nbits] (LSB first): fixed-schedule double-and-add, batched over
    leading axes."""
    acc = identity(p.shape[:-2], device=p.device)
    base = p
    for j in range(bits.shape[-1]):
        acc = select(bits[..., j] != 0, add(acc, base), acc)
        base = double(base)
    return acc


def scalar_limbs_to_bits(s: torch.Tensor, nbits: int = 253) -> torch.Tensor:
    """Canonical scalar limbs [..., NLIMBS] -> bit tensor [..., nbits]."""
    shifts = torch.arange(limb.LIMB_BITS, dtype=torch.int32, device=s.device)
    bits = (s[..., :, None] >> shifts) & 1  # [..., NLIMBS, 13]
    return bits.reshape(*s.shape[:-1], NLIMBS * limb.LIMB_BITS)[..., :nbits]


def on_curve(p: torch.Tensor) -> torch.Tensor:
    """Check -x^2 + y^2 = z^2 + d x^2 y^2 / z^2 and xy = zt (projective)."""
    x, y, z, t = p[..., 0, :], p[..., 1, :], p[..., 2, :], p[..., 3, :]
    d_l = limb.const(limb.int_to_limbs(host.D), p.device)
    x2 = limb.sqr(FP, x)
    y2 = limb.sqr(FP, y)
    z2 = limb.sqr(FP, z)
    lhs = limb.mul(FP, limb.sub(FP, y2, x2), z2)
    rhs = limb.add(
        FP, limb.sqr(FP, z2), limb.mul(FP, d_l, limb.mul(FP, x2, y2))
    )
    curve_ok = limb.eq_mod(FP, lhs, rhs)
    ext_ok = limb.eq_mod(FP, limb.mul(FP, x, y), limb.mul(FP, z, t))
    return curve_ok & ext_ok


def eq_points(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Projective (curve-point) equality: X1 Z2 == X2 Z1 and Y1 Z2 == Y2 Z1."""
    x_ok = limb.eq_mod(
        FP,
        limb.mul(FP, p[..., 0, :], q[..., 2, :]),
        limb.mul(FP, q[..., 0, :], p[..., 2, :]),
    )
    y_ok = limb.eq_mod(
        FP,
        limb.mul(FP, p[..., 1, :], q[..., 2, :]),
        limb.mul(FP, q[..., 1, :], p[..., 2, :]),
    )
    return x_ok & y_ok
