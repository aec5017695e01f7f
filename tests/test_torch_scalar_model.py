"""Word-for-word Python model of csrc/sc25519.cuh (the 10-limb mod-l core of
K1 mul_rows mod l, and the sum and difference of the witness kernels)
against Python integers.

As tests/test_torch_field_model.py does for the mod-p header: every function
below mirrors one device function statement by statement on Python ints that
stand for 32-bit and 64-bit words.  `u32` / `u64` / `i64` assert that a value
a C word would hold has not wrapped, and the casts that do drop bits are
written as explicit masks.  The fold rows and the limbs of l - 2^252 are
read out of the header itself.
"""

import random
import re
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dusk_blindbidproof_tpu_torch.utils import curve_host as host
from test_torch_field_model import (
    ALL_8192, ROW, from_limbs13, limbs13, mul_rows_block, u32, u64,
)

L, P = host.L, host.P
HEADER = (
    Path(__file__).resolve().parents[1]
    / "dusk_blindbidproof_tpu_torch" / "csrc" / "sc25519.cuh"
).read_text()

NL, BITS = 10, 28
MASK = (1 << BITS) - 1
D_LIMBS = 5


def i64(x: int) -> int:
    assert -(1 << 63) <= x < 1 << 63, f"signed 64-bit word wrapped: {x}"
    return x


def _numbers(body: str):
    return [int(t) for t in re.findall(r"(\d+)u", body)]


def _header_d():
    return _numbers(re.search(r"sc_d\[kDLimbs\] = \{([^}]*)\}", HEADER).group(1))


def _header_fold():
    body = re.search(r"sc_fold\[kLimbs\]\[kLimbs\] = \{(.*?)\n\};", HEADER, re.S).group(1)
    return [_numbers(row) for row in re.findall(r"\{([^{}]*)\}", body)]


SC_D = _header_d()
SC_FOLD = _header_fold()


def value(x) -> int:
    return sum(v << (BITS * i) for i, v in enumerate(x))


# --- the header, function by function ---------------------------------------


def sc_load_row(row):
    s, acc = [0] * (ROW + 3), 0
    for j in range(ROW):
        acc = u32(acc + row[j])
        s[j] = acc & 0x1FFF
        acc >>= 13
    s[ROW] = acc
    x = [0] * NL
    for i in range(NL):
        j0, r = divmod(BITS * i, 13)
        win = u64(s[j0] | (s[j0 + 1] << 13) | (s[j0 + 2] << 26) | (s[j0 + 3] << 39))
        x[i] = ((win >> r) & 0xFFFFFFFF) & MASK
    return x


def sc_mul(a, b):
    r, carry = [0] * (2 * NL), 0
    for k in range(2 * NL - 1):
        total = carry
        for i in range(NL):
            j = k - i
            if j < 0 or j >= NL:
                continue
            total = u64(total + u32(a[i]) * u32(b[j]))
        r[k] = (total & 0xFFFFFFFF) & MASK
        carry = total >> BITS
    r[2 * NL - 1] = u32(carry)
    x, carry = [0] * NL, 0
    for j in range(NL):
        total = u64(carry + r[j])
        for k in range(NL):
            total = u64(total + r[NL + k] * SC_FOLD[k][j])
        x[j] = (total & 0xFFFFFFFF) & MASK
        carry = total >> BITS
    hi = u64((carry << BITS) | x[NL - 1])
    y, acc = [0] * NL, 0
    for j in range(NL - 1):
        acc = i64(acc + x[j])
        if j < D_LIMBS:
            acc = i64(acc - i64(u64(hi * SC_D[j])))
        y[j] = (acc & 0xFFFFFFFF) & MASK
        acc >>= BITS
    assert acc in (0, -1)
    neg = acc & 0xFFFFFFFF
    c = 0
    for j in range(NL - 1):
        t = u32(y[j] + ((SC_D[j] & neg) if j < D_LIMBS else 0) + c)
        y[j] = t & MASK
        c = t >> BITS
    y[NL - 1] = c
    return y


def i32(x: int) -> int:
    assert -(1 << 31) <= x < 1 << 31, f"signed 32-bit word wrapped: {x}"
    return x


def sc_l_limb(j):
    return SC_D[j] if j < D_LIMBS else (1 if j == NL - 1 else 0)


def sc_add(a, b):
    s, d, c = [0] * NL, [0] * NL, 0
    for j in range(NL):
        t = u32(a[j] + b[j] + c)
        s[j] = t & MASK
        c = t >> BITS
    assert c == 0
    borrow = 0
    for j in range(NL):
        t = i32(s[j] - sc_l_limb(j) - borrow)
        d[j] = (t & 0xFFFFFFFF) & MASK
        borrow = int(t < 0)
    return s if borrow else d


def sc_sub(a, b):
    d, borrow = [0] * NL, 0
    for j in range(NL):
        t = i32(a[j] - b[j] - borrow)
        d[j] = (t & 0xFFFFFFFF) & MASK
        borrow = int(t < 0)
    neg = (0 - borrow) & 0xFFFFFFFF
    c = 0
    for j in range(NL):
        t = u32(d[j] + (sc_l_limb(j) & neg) + c)
        d[j] = t & MASK
        c = t >> BITS
    return d


def sc_store_row(a):
    row = [0] * ROW
    for j in range(ROW):
        i = (13 * j) // BITS
        sh = 13 * j - BITS * i
        win = u64(a[i] | ((a[i + 1] << BITS) if i + 1 < NL else 0))
        row[j] = ((win >> sh) & 0xFFFFFFFF) & 0x1FFF
    return row


# --- tests -------------------------------------------------------------------

EDGES = {
    "0": limbs13(0),
    "1": limbs13(1),
    "l-1": limbs13(L - 1),
    "l": limbs13(L),
    "l+1": limbs13(L + 1),
    "2^252-1": limbs13(2**252 - 1),
    "2^252": limbs13(2**252),
    "p-1": limbs13(P - 1),
    "p": limbs13(P),
    "limb-20": limbs13(1 << 260),
    "2^273-1": limbs13(2**273 - 1),
    "all-8192": ALL_8192,
}

rows = st.lists(st.integers(0, 8192), min_size=ROW, max_size=ROW)


def test_header_constants():
    assert value(SC_D) == L - 2**252 and len(SC_D) == D_LIMBS
    assert len(SC_FOLD) == NL and all(len(r) == NL for r in SC_FOLD)
    for k, row in enumerate(SC_FOLD):
        assert value(row) == pow(2, BITS * (NL + k), L)
        assert all(v <= MASK for v in row)
    assert BITS * (NL - 1) == 252  # limb 9 starts at the bit of l's leading one


@pytest.mark.parametrize("name", list(EDGES))
def test_load_edges(name):
    x = sc_load_row(EDGES[name])
    assert value(x) == from_limbs13(EDGES[name])  # the load only repacks
    assert all(v <= MASK for v in x) and x[9] < 1 << 22


@pytest.mark.parametrize("a", list(EDGES))
@pytest.mark.parametrize("b", list(EDGES))
def test_mul_on_edge_pairs(a, b):
    va, vb = from_limbs13(EDGES[a]), from_limbs13(EDGES[b])
    y = sc_mul(sc_load_row(EDGES[a]), sc_load_row(EDGES[b]))
    assert all(v <= MASK for v in y) and y[9] <= 1
    assert value(y) == va * vb % L
    out = sc_store_row(y)
    assert out == limbs13(va * vb % L) and out[20] == 0


def test_store_of_every_canonical_bit():
    for bit in range(253):
        v = (1 << bit) % L
        x = [(v >> (BITS * i)) & MASK for i in range(NL)]
        assert sc_store_row(x) == limbs13(v)
    assert sc_store_row([(L - 1 >> (BITS * i)) & MASK for i in range(NL)]) == limbs13(L - 1)


def test_both_signs_of_the_last_fold():
    """lo - hi D goes negative (and l is added back) for some products and
    stays nonnegative for others; both branches are exact."""
    seen = set()
    rng = random.Random(11)
    cases = [(L - 1, L - 1), (1, 1), (2**252, 2**21), (2**252 + 1, 2**252 + 1)]
    cases += [(rng.randrange(2**273), rng.randrange(2**273)) for _ in range(200)]
    for va, vb in cases:
        a, b = sc_load_row(limbs13(va)), sc_load_row(limbs13(vb))
        y = sc_mul(a, b)
        assert value(y) == va * vb % L
        seen.add(value(y) >= 2**252 or _went_negative(a, b))
    assert seen == {True, False}


def _went_negative(a, b) -> bool:
    """Recomputes the sign of lo - hi D from the model's first fold."""
    prod = value(a) * value(b)
    folded = prod % (1 << (BITS * NL)) + sum(
        ((prod >> (BITS * (NL + k))) & MASK) * value(SC_FOLD[k]) for k in range(NL - 1)
    ) + (prod >> (BITS * (2 * NL - 1))) * value(SC_FOLD[NL - 1])
    return folded % (1 << 252) - (folded >> 252) * (L - 2**252) < 0


@settings(max_examples=300, deadline=None)
@given(rows, rows)
def test_mul_random_rows(wa, wb):
    va, vb = from_limbs13(wa), from_limbs13(wb)
    y = sc_mul(sc_load_row(wa), sc_load_row(wb))
    assert value(y) == va * vb % L
    assert sc_store_row(y) == limbs13(va * vb % L)


@settings(max_examples=100, deadline=None)
@given(st.integers(0, L - 1), st.integers(0, L - 1))
def test_mul_canonical_scalars(va, vb):
    y = sc_mul(sc_load_row(limbs13(va)), sc_load_row(limbs13(vb)))
    assert from_limbs13(sc_store_row(y)) == va * vb % L


@pytest.mark.parametrize("a_mis,b_mis,out_mis", [(0, 0, 0), (3, 1, 2)])
def test_mul_rows_block_model_mod_l(a_mis, b_mis, out_mis):
    """The block's copy through shared memory with the mod-l element."""
    rng = random.Random(13)
    n = 7
    nwords = n * ROW
    a = [[rng.randrange(8193) for _ in range(ROW)] for _ in range(n)]
    b = [[rng.randrange(8193) for _ in range(ROW)] for _ in range(n)]
    a[0], b[0], a[1], b[1] = ALL_8192, ALL_8192, limbs13(L - 1), limbs13(L - 1)
    memory = [-1] * (3 * (nwords + 8))
    a_addr, b_addr = 4 * (4 + a_mis), 4 * (nwords + 12 + b_mis)
    out_addr = 4 * (2 * nwords + 20 + out_mis)
    memory[a_addr >> 2:(a_addr >> 2) + nwords] = [w for r in a for w in r]
    memory[b_addr >> 2:(b_addr >> 2) + nwords] = [w for r in b for w in r]
    mul_rows_block(memory, a_addr, b_addr, out_addr, n, sc_load_row, sc_mul, sc_store_row)
    o = out_addr >> 2
    for t in range(n):
        want = from_limbs13(a[t]) * from_limbs13(b[t]) % L
        assert memory[o + ROW * t:o + ROW * (t + 1)] == limbs13(want)


def _limbs28(v):
    return [(v >> (BITS * i)) & MASK for i in range(NL)]


CANONICAL_EDGES = [0, 1, 2, L - 2, L - 1, 2**252 - 1, 2**252, L // 2, L // 2 + 1,
                   (1 << BITS) - 1, 1 << BITS]


@pytest.mark.parametrize("op", ["add", "sub"])
def test_add_and_sub_on_canonical_edges(op):
    fn, want = (sc_add, lambda a, b: (a + b) % L) if op == "add" else (
        sc_sub, lambda a, b: (a - b) % L)
    for va in CANONICAL_EDGES:
        for vb in CANONICAL_EDGES:
            y = fn(_limbs28(va), _limbs28(vb))
            assert all(v <= MASK for v in y) and y[9] <= 1
            assert value(y) == want(va, vb), (va, vb)
            assert sc_store_row(y) == limbs13(want(va, vb))


@settings(max_examples=200, deadline=None)
@given(st.integers(0, L - 1), st.integers(0, L - 1))
def test_add_and_sub_canonical_scalars(va, vb):
    a, b = _limbs28(va), _limbs28(vb)
    assert value(sc_add(a, b)) == (va + vb) % L
    assert value(sc_sub(a, b)) == (va - vb) % L
    # a load of 13-bit limbs, then the product by one, canonicalises any row
    # the kernels read before they add
    one = _limbs28(1)
    assert value(sc_mul(sc_load_row(limbs13(va + L)), one)) == va
