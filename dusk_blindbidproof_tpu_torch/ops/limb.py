"""Batched modular bignum arithmetic on tensors: 13-bit limbs in int32.

PyTorch counterpart of the JAX package's limb engine, with the same layout
at every public function so tensors pass to and from JAX arrays through
numpy:

    element = sum_i limb[i] * 2^(13*i),  limb[i] small nonneg,  21 limbs.

Schoolbook partial products are ~26-bit and a full product column sums 21
of them (< 2^31), so every intermediate fits an int32 with no carry handling
inside the inner loop.

Bound tracking.  Every intermediate carries a per-limb magnitude bound
vector and an exact value upper bound (python ints).  The reducer chooses,
from those bounds, exactly the parallel carry passes and residue folds an
op needs, and asserts every intermediate < 2^31: int32 tensor products wrap
silently, so the asserts are the overflow proof.  The bounds are python
ints, so the tracker runs eagerly around each tensor op.

Working form ("std"): 21 limbs; limbs 0..19 <= 2^13, limb 20 (slack) <= 1;
value < 2^261.  All public ops accept any nonneg tensor with limbs <= 2^13
and return std.  Canonical reduction to [0, M) happens at byte boundaries
(`canon`).

Dispatch: `mul`/`sqr` on a CUDA tensor always launch the hand-written
modular-product kernel (`ops.fused.mul_rows`, which returns canonical
limbs, a valid std form); on a CPU tensor they run the plain `lb_mul`.

One engine serves both moduli:
    * F_p, p = 2^255-19 (point coordinates);
    * F_l, l = 2^252 + 27742317777372353535851937790883648493 (scalars).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

LIMB_BITS = 13
NLIMBS = 21
LIMB_MASK = (1 << LIMB_BITS) - 1
PROD_LIMBS = 2 * NLIMBS - 1  # limbs of a full product before reduction

INT32_SAFE = (1 << 31) - 1
# std working form: limbs 0..19 <= STD_LO, limb 20 <= STD_TOP, value < 2^261
STD_LO = 1 << LIMB_BITS
STD_TOP = 1
# max limb magnitude for the exact carry-lookahead (carries stay in {0,1})
EXACT_MAX = 2 * LIMB_MASK


def int_to_limbs(x: int, nlimbs: int = NLIMBS) -> np.ndarray:
    out = np.zeros(nlimbs, dtype=np.int32)
    for i in range(nlimbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    assert x == 0, "value does not fit"
    return out


def limbs_to_int(limbs) -> int:
    limbs = _np(limbs)
    return sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(limbs.reshape(-1)))


def ints_to_limbs(xs, nlimbs: int = NLIMBS) -> np.ndarray:
    """Vector of python ints -> [len(xs), nlimbs] int32."""
    return np.stack([int_to_limbs(int(x), nlimbs) for x in xs])


def limbs_to_ints(arr) -> list[int]:
    arr = _np(arr)
    flat = arr.reshape(-1, arr.shape[-1])
    return [
        sum(int(v) << (LIMB_BITS * i) for i, v in enumerate(row)) for row in flat
    ]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _redigit_at_least(value: int, minimums, ndigits: int) -> np.ndarray:
    """Decompose `value` into base-2^13 digits with digit[j] >= minimums[j].

    Greedy from the bottom: after fixing digit j, the remaining mass is kept
    in the higher digits.  Raises if the value has insufficient mass.
    """
    digits = []
    rem = value
    for j in range(ndigits):
        d = rem & LIMB_MASK
        need = int(minimums[j]) if j < len(minimums) else 0
        while d < need:
            d += 1 << LIMB_BITS
        digits.append(d)
        rem = (rem - d) >> LIMB_BITS
        assert rem >= 0, "insufficient mass for re-digiting"
    assert rem == 0
    assert sum(d << (LIMB_BITS * j) for j, d in enumerate(digits)) == value
    assert max(digits) <= INT32_SAFE
    return np.array(digits, dtype=np.int32)


_FOLD_KMAX = 2 * NLIMBS + 6  # widest width the reducer can ever see


@dataclass(frozen=True, eq=False)  # identity hash: usable as a cache key
class ModContext:
    """Precomputed reduction tables for one modulus (built once, on host)."""

    modulus: int
    name: str
    # fold_rows[k] = limbs of (2^(13*(NLIMBS+k)) mod modulus): the residue of
    # the weight of "overflow limb" NLIMBS+k.   [_FOLD_KMAX, NLIMBS]
    fold_rows: np.ndarray = field(repr=False)
    fold_ints: tuple = field(repr=False)  # their integer values
    # Residue of the slack limb's weight, 2^260 mod modulus.   [NLIMBS]
    top_row: np.ndarray = field(repr=False)
    top_int: int = 0
    # Canonicalization split: value = lo + hi * 2^split_bit with hi < hi_max.
    #   canon_neg False: value ≡ lo + hi * R          (p: R = 19)
    #   canon_neg True:  value ≡ lo - hi * D, computed borrow-free as
    #                    lo + (A - hi * D) where A = k*M redigited so every
    #                    digit dominates hi_max * D's digits (l: D = l - 2^252)
    split_bit: int = 0
    hi_max: int = 0
    canon_neg: bool = False
    canon_row: np.ndarray = field(repr=False, default=None)  # [NLIMBS] R or D
    canon_adjust: np.ndarray = field(repr=False, default=None)  # [NLIMBS]
    canon_adjust_int: int = 0
    canon_vmax: int = 0  # value bound right after the split-fold
    mod_limbs: np.ndarray = field(repr=False, default=None)  # [NLIMBS]
    # Digits of (2^(13*(NLIMBS+1)) - modulus): x + comp carries into bit
    # 13*(NLIMBS+1) iff x >= modulus.   [NLIMBS + 1]
    cond_sub_comp: np.ndarray = field(repr=False, default=None)
    cond_sub_int: int = 0

    @staticmethod
    def create(modulus: int, name: str, split_bit: int) -> "ModContext":
        fold_ints = tuple(
            pow(2, LIMB_BITS * (NLIMBS + k), modulus) for k in range(_FOLD_KMAX)
        )
        fold_rows = np.stack([int_to_limbs(r) for r in fold_ints])
        top_int = pow(2, 13 * (NLIMBS - 1), modulus)  # 2^260 mod M
        top_row = int_to_limbs(top_int)

        # canonicalization tables: inputs are strict with value < 2^261
        hi_max = 1 << (13 * NLIMBS - 13 + 1 - split_bit)  # value>>split < hi_max
        rpos = pow(2, split_bit, modulus)
        rneg = modulus - rpos
        if rpos <= rneg:
            canon_neg = False
            row = int_to_limbs(rpos)
            adjust = np.zeros(NLIMBS, dtype=np.int32)
            adjust_int = 0
            canon_vmax = (1 << split_bit) + (hi_max - 1) * rpos
        else:
            canon_neg = True
            row = int_to_limbs(rneg)
            mins = [int(v) * (hi_max - 1) for v in row]
            assert max(mins) <= INT32_SAFE
            need = sum(mn << (LIMB_BITS * j) for j, mn in enumerate(mins))
            k = need // modulus + 1
            adjust = _redigit_at_least(k * modulus, mins, NLIMBS)
            adjust_int = k * modulus
            canon_vmax = (1 << split_bit) + adjust_int

        comp = (1 << (LIMB_BITS * (NLIMBS + 1))) - modulus
        cond_sub_comp = int_to_limbs(comp, NLIMBS + 1)
        return ModContext(
            modulus=modulus,
            name=name,
            fold_rows=fold_rows,
            fold_ints=fold_ints,
            top_row=top_row,
            top_int=top_int,
            split_bit=split_bit,
            hi_max=hi_max,
            canon_neg=canon_neg,
            canon_row=row,
            canon_adjust=adjust,
            canon_adjust_int=adjust_int,
            canon_vmax=canon_vmax,
            mod_limbs=int_to_limbs(modulus),
            cond_sub_comp=cond_sub_comp,
            cond_sub_int=comp,
        )


P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493

FP = ModContext.create(P, "fp", split_bit=255)
FL = ModContext.create(L, "fl", split_bit=252)


# ---------------------------------------------------------------------------
# Host constants on the device.  A table is uploaded once per device and
# reused: a fresh host-to-device copy per op would stall the stream.
# ---------------------------------------------------------------------------

_CONSTS: dict = {}


def const(arr, device) -> torch.Tensor:
    """Host int32 table -> cached tensor on `device`."""
    a = np.ascontiguousarray(np.asarray(arr, dtype=np.int32))
    device = torch.device(device)
    key = (a.shape, a.tobytes(), device)
    t = _CONSTS.get(key)
    if t is None:
        t = torch.from_numpy(a.copy()).to(device)
        _CONSTS[key] = t
    return t


def _pad_limb(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return F.pad(x, (lo, hi))


# ---------------------------------------------------------------------------
# Bound-tracked limb vectors.
#
# An `LB` pairs an int32 limb tensor with python-int metadata: a tuple of
# per-limb magnitude upper bounds and an exact value upper bound.  All
# structural decisions (how many carry passes, when to fold) are made from
# this metadata, and every intermediate is PROVEN < 2^31.
# ---------------------------------------------------------------------------


class LB(NamedTuple):
    x: torch.Tensor  # [..., w] int32, 0 <= limb[j] <= b[j]
    b: tuple  # per-limb bounds (python ints)
    v: int  # exact value upper bound (python int)

    @property
    def width(self) -> int:
        return len(self.b)


def wrap(x: torch.Tensor, bound=None, v=None) -> LB:
    """Wrap a raw tensor.  Default bound 2^13 per limb (covers both strict
    decodes and std-form op outputs)."""
    w = x.shape[-1]
    if bound is None:
        b = (1 << LIMB_BITS,) * w
    elif np.isscalar(bound):
        b = (int(bound),) * w
    else:
        b = tuple(int(t) for t in np.asarray(bound).reshape(-1))
    assert len(b) == w, (len(b), w)
    assert max(b) <= INT32_SAFE
    if w < NLIMBS:
        x = _pad_limb(x, 0, NLIMBS - w)
        b = b + (0,) * (NLIMBS - w)
    vi = _implied(b)
    return LB(x, b, min(vi, v) if v is not None else vi)


# ---------------------------------------------------------------------------
# Reduction plans.
#
# Every structural decision of a reduction (which carry pass, which fold)
# depends only on the bounds, so `_reduce_plan` derives the whole stage list
# from (modulus, bounds, value bound) once, caches it, and `reduce_std`
# replays it on the tensor: the bound bookkeeping costs one dict lookup per
# call instead of a few hundred python operations.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _implied(b) -> int:
    return sum(int(bj) << (LIMB_BITS * j) for j, bj in enumerate(b))


def _refine_bounds(b: tuple, v: int):
    """Tighten per-limb bounds by the value bound and drop zero-bound tops."""
    v = min(v, _implied(b))
    b = tuple(min(int(bj), v >> (LIMB_BITS * j)) for j, bj in enumerate(b))
    while len(b) > NLIMBS and b[-1] == 0:
        b = b[:-1]
    return b, v


def _carry_pass_bounds(b: tuple, v: int):
    """One parallel carry pass: out_j = (x_j & mask) + (x_{j-1} >> 13).

    The top limb is split (appending a new limb) only when the value bound
    allows a carry past the current width; otherwise it is kept whole so no
    mass is lost.  Value-invariant."""
    w = len(b)
    cb = [bj >> LIMB_BITS for bj in b]
    lob = [min(bj, LIMB_MASK) for bj in b]
    if min(cb[-1], v >> (LIMB_BITS * w)) > 0:
        mode = "escape"
        nb = [lob[j] + (cb[j - 1] if j else 0) for j in range(w)] + [cb[-1]]
    elif cb[-1] > 0:  # carry out of the top limb is impossible by value
        mode = "keep_top"
        nb = [lob[j] + (cb[j - 1] if j else 0) for j in range(w - 1)]
        nb.append(b[-1] + (cb[-2] if w > 1 else 0))
    else:
        mode = "plain"
        nb = [lob[j] + (cb[j - 1] if j else 0) for j in range(w)]
    return tuple(nb), v, ("carry", mode)


def _carry_multi_bounds(b: tuple, v: int):
    """Multi-split carry: decompose every limb into its base-2^13 digits and
    re-add them shifted.  One pass takes any int32-safe bound down to
    ~depth*2^13.  Value-invariant; width grows by depth-1 (folds contract
    it after)."""
    depth = max(2, -(-max(b).bit_length() // LIMB_BITS))
    w = len(b)
    nb = [0] * (w + depth - 1)
    for d in range(depth):
        for j in range(w):
            bd = int(b[j]) >> (LIMB_BITS * d)
            if d < depth - 1:
                bd = min(bd, LIMB_MASK)
            nb[j + d] += bd
    assert max(nb) <= INT32_SAFE
    return tuple(nb), v, ("multi", depth)


def _fold_contrib(ctx: ModContext, b) -> tuple:
    """Per-limb bound after folding limbs >= NLIMBS (python ints)."""
    k = len(b) - NLIMBS
    out = list(b[:NLIMBS])
    for i in range(k):
        row = ctx.fold_rows[i]
        for j in range(NLIMBS):
            out[j] += int(b[NLIMBS + i]) * int(row[j])
    return tuple(out)


def _fold_bounds(ctx: ModContext, b: tuple, v: int):
    """Fold limbs >= NLIMBS back via residue rows (value preserved mod M)."""
    k = len(b) - NLIMBS
    assert 0 < k <= _FOLD_KMAX
    nb = _fold_contrib(ctx, b)
    assert max(nb) <= INT32_SAFE, f"fold overflow for {ctx.name}"
    nv = _implied(b[:NLIMBS]) + sum(
        min(int(b[NLIMBS + i]), v >> (LIMB_BITS * (NLIMBS + i))) * ctx.fold_ints[i]
        for i in range(k)
    )
    return nb, min(nv, _implied(nb)), ("fold", k)


def _fold_top_bounds(ctx: ModContext, b: tuple, v: int):
    """Fold the slack limb (index 20) via 2^260 mod M (value kept mod M)."""
    assert len(b) == NLIMBS
    bt = int(b[NLIMBS - 1])
    nb = list(b[: NLIMBS - 1]) + [0]
    for j in range(NLIMBS):
        nb[j] += bt * int(ctx.top_row[j])
    nb = tuple(nb)
    assert max(nb) <= INT32_SAFE, f"fold_top overflow for {ctx.name}"
    nv = _implied(b[: NLIMBS - 1]) + (
        min(bt, v >> (LIMB_BITS * (NLIMBS - 1))) * ctx.top_int
    )
    return nb, min(nv, _implied(nb)), ("fold_top",)


def _carry_stage_bounds(b: tuple, v: int):
    """Multi-split when a single pass would need >=2 successors, else the
    cheap single pass."""
    if max(int(bj) for bj in b) >= (1 << (2 * LIMB_BITS)):
        return _carry_multi_bounds(b, v)
    return _carry_pass_bounds(b, v)


@functools.lru_cache(maxsize=None)
def _reduce_plan(ctx: ModContext, b: tuple, v: int):
    """Stages taking bounds (b, v) to std form (21 limbs: <= 2^13, slack
    limb <= 1, value < 2^261), preserving value mod M; every stage is
    int32-safe; terminates (folds contract the value geometrically).
    Returns (stages, final bounds, final value bound)."""
    steps = []
    for _ in range(200):
        w0 = len(b)
        b, v = _refine_bounds(b, v)
        if len(b) != w0:
            steps.append(("cut", len(b)))
        w = len(b)
        if w == NLIMBS and max(b[: NLIMBS - 1]) <= STD_LO and b[NLIMBS - 1] <= STD_TOP:
            return tuple(steps), b, v
        if w > NLIMBS:
            if max(_fold_contrib(ctx, b)) <= INT32_SAFE:
                b, v, step = _fold_bounds(ctx, b, v)
            else:
                b, v, step = _carry_stage_bounds(b, v)
            steps.append(step)
            continue
        # Fold the slack limb FIRST: it carries the 2^260-scale mass that
        # keeps the value bound (and hence the refine cap on itself) large;
        # carrying first can cycle via escape->fold(row 0) re-injection.
        bt = b[NLIMBS - 1]
        if bt > STD_TOP and bt * int(ctx.top_row.max()) + max(b[: NLIMBS - 1]) <= INT32_SAFE:
            b, v, step = _fold_top_bounds(ctx, b, v)
        else:
            b, v, step = _carry_stage_bounds(b, v)
        steps.append(step)
    raise AssertionError(f"reduce_std did not converge: bounds {b}")


def _apply(ctx: ModContext, x: torch.Tensor, step) -> torch.Tensor:
    kind = step[0]
    if kind == "cut":
        return x[..., : step[1]]
    if kind == "fold":
        k = step[1]
        lo, hi = x[..., :NLIMBS], x[..., NLIMBS:]
        rows = const(ctx.fold_rows[:k], x.device)  # [k, NLIMBS]
        # exact int32 multiply-adds (the plan proved no wrap), one per row:
        # CUDA has no int32 GEMM
        folded = lo
        for i in range(k):
            folded = folded + hi[..., i : i + 1] * rows[i]
        return folded
    if kind == "fold_top":
        base = _pad_limb(x[..., : NLIMBS - 1], 0, 1)
        return base + x[..., NLIMBS - 1 :] * const(ctx.top_row, x.device)
    if kind == "carry":
        w = x.shape[-1]
        c = x >> LIMB_BITS
        lo = x & LIMB_MASK
        c_in = _pad_limb(c, 1, 0)[..., :w]
        if step[1] == "escape":
            return _pad_limb(lo + c_in, 0, 1) + _pad_limb(c[..., w - 1 :], w, 0)
        if step[1] == "keep_top":
            return torch.cat([lo[..., : w - 1], x[..., w - 1 :]], dim=-1) + c_in
        return lo + c_in
    if kind == "multi":
        depth = step[1]
        out = None
        for d in range(depth):
            p = x >> (LIMB_BITS * d)
            if d < depth - 1:
                p = p & LIMB_MASK
            pad = _pad_limb(p, d, depth - 1 - d)
            out = pad if out is None else out + pad
        return out
    raise ValueError(kind)


def reduce_std(ctx: ModContext, a: LB) -> LB:
    """Reduce to std form (21 limbs: <= 2^13, slack limb <= 1, value
    < 2^261), preserving value mod M, by replaying the cached plan."""
    steps, b, v = _reduce_plan(ctx, a.b, a.v)
    x = a.x
    for step in steps:
        x = _apply(ctx, x, step)
    return LB(x, b, v)


def lb_raw_add(a: LB, c: LB) -> LB:
    """Plain limb-wise sum (no reduction), with the overflow check."""
    wa, wc = a.width, c.width
    if wa < wc:
        a = LB(_pad_limb(a.x, 0, wc - wa), a.b + (0,) * (wc - wa), a.v)
    elif wc < wa:
        c = LB(_pad_limb(c.x, 0, wa - wc), c.b + (0,) * (wa - wc), c.v)
    nb = tuple(x + y for x, y in zip(a.b, c.b))
    assert max(nb) <= INT32_SAFE, "limb add would overflow int32"
    return LB(a.x + c.x, nb, a.v + c.v)


@functools.lru_cache(maxsize=None)
def _product_bounds(ab: tuple, cb: tuple) -> tuple:
    colb = np.convolve(np.array(ab, dtype=object), np.array(cb, dtype=object))
    colb = tuple(int(t) for t in colb)
    assert max(colb) <= INT32_SAFE
    return colb


def lb_mul(ctx: ModContext, a: LB, c: LB) -> LB:
    """Schoolbook product: 21 shifted broadcast multiply-adds into the
    41 product columns, then bound-driven reduction (441 int32 MACs per
    element)."""
    a = reduce_std(ctx, a)
    c = reduce_std(ctx, c)
    colb = _product_bounds(a.b, c.b)
    shape = torch.broadcast_shapes(a.x.shape[:-1], c.x.shape[:-1])
    cols = torch.zeros((*shape, PROD_LIMBS), dtype=torch.int32, device=a.x.device)
    for i in range(NLIMBS):
        cols[..., i : i + NLIMBS] += a.x[..., i : i + 1] * c.x
    return reduce_std(ctx, LB(cols, colb, a.v * c.v))


@functools.lru_cache(maxsize=None)
def _sub_digits(ctx: ModContext, cb: tuple):
    need = _implied(cb)
    k = need // ctx.modulus + 1
    return _redigit_at_least(k * ctx.modulus, cb, NLIMBS), k * ctx.modulus


def lb_sub(ctx: ModContext, a: LB, c: LB) -> LB:
    """a - c mod M, borrow-free: a + (S - c) with S = k*M redigited so every
    digit dominates c's bound."""
    c = reduce_std(ctx, c)
    digits, s = _sub_digits(ctx, c.b)
    dneg = LB(const(digits, c.x.device) - c.x, tuple(int(d) for d in digits), s)
    return lb_raw_add(a, dneg)


# ---------------------------------------------------------------------------
# Public working-form ops (raw tensors; outputs in std form)
# ---------------------------------------------------------------------------


def add(ctx: ModContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return reduce_std(ctx, lb_raw_add(wrap(a), wrap(b))).x


def add_many(ctx: ModContext, terms: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Sum up to ~260k std elements along `dim` in one int32 reduction."""
    n = terms.shape[dim]
    assert n * (1 << LIMB_BITS) <= INT32_SAFE, "too many terms for one int32 sum"
    s = terms.sum(dim=dim, dtype=torch.int32)  # torch.sum(int32) is int64 by default
    return reduce_std(ctx, wrap(s, bound=n * (1 << LIMB_BITS))).x


def sub(ctx: ModContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return reduce_std(ctx, lb_sub(ctx, wrap(a), wrap(b))).x


def neg(ctx: ModContext, b: torch.Tensor) -> torch.Tensor:
    return sub(ctx, torch.zeros_like(b), b)


def mul(ctx: ModContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b mod M.  CUDA tensors always go to the hand-written kernel."""
    if a.is_cuda or b.is_cuda:
        from . import fused

        return fused.mul_rows(ctx, *fused.kernel_operands(a, b))
    return lb_mul(ctx, wrap(a), wrap(b)).x


def sqr(ctx: ModContext, a: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:  # one operand, handed over twice: the kernel takes its square
        from . import fused

        (a,) = fused.kernel_operands(a)
        return fused.mul_rows(ctx, a, a)
    return mul(ctx, a, a)


def mul_small(ctx: ModContext, a: torch.Tensor, k: int) -> torch.Tensor:
    assert 0 <= k <= LIMB_MASK
    aw = wrap(a)
    return reduce_std(
        ctx, LB(aw.x * k, tuple(t * k for t in aw.b), aw.v * k)
    ).x


def normalize(ctx: ModContext, x: torch.Tensor, bound: int = INT32_SAFE) -> torch.Tensor:
    """Reduce nonneg limbs (each <= `bound`, any width) to std form."""
    return reduce_std(ctx, wrap(x, bound=bound)).x


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond ? a : b with cond shaped [...] against [..., NLIMBS] operands."""
    return torch.where(cond[..., None], a, b)


# ---------------------------------------------------------------------------
# Exact strict form and canonical reduction
# ---------------------------------------------------------------------------


def _shift_limbs(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., j] -> x[..., j-k] with zeros shifted in at the bottom."""
    return _pad_limb(x, k, 0)[..., : x.shape[-1]]


def _exact_carry(a: LB) -> LB:
    """Limbs (each <= 2*2^13-2) -> strict limbs < 2^13 via a Hillis-Steele
    carry-lookahead over (generate, propagate) pairs; appends a top limb
    only when both the limb bounds and the value bound allow a carry out.
    ~log2(width) parallel steps, no sequential carry chain."""
    assert max(a.b) <= EXACT_MAX, a.b
    g = a.x >> LIMB_BITS  # in {0, 1}
    r = a.x & LIMB_MASK
    p = (r == LIMB_MASK).to(torch.int32)
    w = a.width
    off = 1
    while off < w:
        # zeros shift in below limb 0: there is no carry into the bottom
        g = g | (p & _shift_limbs(g, off))
        p = p & _shift_limbs(p, off)
        off *= 2
    out = (r + _shift_limbs(g, 1)) & LIMB_MASK
    nb = [min(int(bj), LIMB_MASK) for bj in a.b]
    can_escape = (a.b[-1] + 1) >> LIMB_BITS > 0 or a.b[-1] == LIMB_MASK
    if can_escape and (a.v >> (LIMB_BITS * w)) > 0:
        out = torch.cat([out, g[..., -1:]], dim=-1)
        nb.append(1)
    return LB(out, tuple(nb), a.v)


def _to_strict(ctx: ModContext, a: LB) -> LB:
    """Any bounds -> width-NLIMBS strict limbs (< 2^13), value mod M kept."""
    a = reduce_std(ctx, a)
    a = _exact_carry(a)  # std bounds <= 2^13 <= EXACT_MAX; no escape (v<2^261)
    assert a.width == NLIMBS
    return a


def _cond_sub_modulus(ctx: ModContext, a: LB) -> LB:
    """One step of x >= M ? x - M : x on strict limbs (all parallel).

    x + (2^(13*22) - M) has the 2^(13*22) bit set iff x >= M; the low limbs
    of that sum are then exactly x - M."""
    assert a.width == NLIMBS and max(a.b) <= LIMB_MASK
    comp = ctx.cond_sub_comp  # [NLIMBS+1] digits, each <= LIMB_MASK
    x22 = _pad_limb(a.x, 0, 1)
    s = LB(
        x22 + const(comp, a.x.device),
        tuple(
            int(bj) + int(comp[j]) for j, bj in enumerate(list(a.b) + [0])
        ),
        a.v + ctx.cond_sub_int,
    )
    s = _exact_carry(s)
    if s.width > NLIMBS + 1:
        ge = s.x[..., NLIMBS + 1] == 1
    else:
        ge = torch.zeros(s.x.shape[:-1], dtype=torch.bool, device=a.x.device)
    out = torch.where(ge[..., None], s.x[..., :NLIMBS], a.x)
    nv = max(ctx.modulus - 1, a.v - ctx.modulus)
    return LB(out, (LIMB_MASK,) * NLIMBS, min(nv, a.v))


def canon(ctx: ModContext, x: torch.Tensor, bound: int = INT32_SAFE) -> torch.Tensor:
    """Full canonical reduction to [0, M): strict limbs, width NLIMBS."""
    a = _to_strict(ctx, wrap(x, bound=min(int(bound), INT32_SAFE)))
    # split: value = lo + hi * 2^split_bit, hi < hi_max (value < 2^261)
    sb_limb, sb_off = divmod(ctx.split_bit, LIMB_BITS)
    assert sb_limb == NLIMBS - 2
    hi = (a.x[..., sb_limb] >> sb_off) + (
        a.x[..., NLIMBS - 1] << (LIMB_BITS - sb_off)
    )
    hi_b = (LIMB_MASK >> sb_off) + (
        min(int(a.b[NLIMBS - 1]), a.v >> (LIMB_BITS * (NLIMBS - 1)))
        << (LIMB_BITS - sb_off)
    )
    assert hi_b < ctx.hi_max, (hi_b, ctx.hi_max)
    lo = torch.cat(
        [
            a.x[..., :sb_limb],
            a.x[..., sb_limb : sb_limb + 1] & ((1 << sb_off) - 1),
            torch.zeros_like(a.x[..., sb_limb + 1 :]),
        ],
        dim=-1,
    )
    lo_b = (LIMB_MASK,) * sb_limb + ((1 << sb_off) - 1,) + (0,) * (
        NLIMBS - sb_limb - 1
    )
    row = const(ctx.canon_row, a.x.device)
    if ctx.canon_neg:
        adj = ctx.canon_adjust.astype(np.int64)
        term = const(ctx.canon_adjust, a.x.device) - hi[..., None] * row
        tb = tuple(int(t) for t in adj)  # term in [0, adjust] per digit
        tv = ctx.canon_adjust_int
    else:
        term = hi[..., None] * row
        tb = tuple(hi_b * int(t) for t in ctx.canon_row)
        tv = hi_b * limbs_to_int(ctx.canon_row)
    y = lb_raw_add(LB(lo, lo_b, _implied(lo_b)), LB(term, tb, tv))
    y = LB(y.x, y.b, min(y.v, ctx.canon_vmax))
    y = _to_strict(ctx, y)
    for _ in range(8):
        if y.v < ctx.modulus:
            break
        y = _cond_sub_modulus(ctx, y)
    assert y.v < ctx.modulus, "canon cond-sub did not converge"
    return y.x


def eq_mod(ctx: ModContext, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise modular equality of two working-form values."""
    return (canon(ctx, a) == canon(ctx, b)).all(dim=-1)


def is_zero(ctx: ModContext, a: torch.Tensor) -> torch.Tensor:
    return (canon(ctx, a) == 0).all(dim=-1)


# ---------------------------------------------------------------------------
# Byte / integer conversions for device IO (host numpy)
# ---------------------------------------------------------------------------


def limbs_from_bytes_le(data: np.ndarray) -> np.ndarray:
    """[..., 32] uint8 -> [..., NLIMBS] int32 (values < 2^256; strict limbs)."""
    data = np.asarray(data, dtype=np.uint8)
    bits = np.unpackbits(data, axis=-1, bitorder="little")  # [..., 256]
    pad = NLIMBS * LIMB_BITS - 256
    bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    bits = bits.reshape(*bits.shape[:-1], NLIMBS, LIMB_BITS)
    weights = 1 << np.arange(LIMB_BITS, dtype=np.int32)
    return (bits.astype(np.int32) * weights).sum(axis=-1, dtype=np.int32)


def ints_to_limbs_fast(vals, out_shape=None) -> np.ndarray:
    """Vectorized python-ints (< 2^256) -> limb rows via byte packing."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(len(vals), 32)
    out = limbs_from_bytes_le(arr)
    if out_shape is not None:
        out = out.reshape(*out_shape, NLIMBS)
    return out


def limbs_to_bytes_le(limbs) -> np.ndarray:
    """[..., NLIMBS] canonical limbs -> [..., 32] uint8 little-endian."""
    limbs = _np(limbs)
    bits = ((limbs[..., None] >> np.arange(LIMB_BITS)) & 1).astype(np.uint8)
    bits = bits.reshape(*limbs.shape[:-1], NLIMBS * LIMB_BITS)[..., :256]
    return np.packbits(bits, axis=-1, bitorder="little")
