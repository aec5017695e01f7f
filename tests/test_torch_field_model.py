"""Word-for-word Python model of csrc/fe25519.cuh (the 10-limb mod-p core of
every mod-p kernel) against Python integers.

The CUDA header cannot run on the CPU; its arithmetic can.  Every function
below mirrors one device function statement by statement, on Python ints
that stand for 32-bit and 64-bit words: `u32` / `u64` assert that a value a
C word would hold has not wrapped (stronger than masking: the header relies
on no wrap), and the casts that do drop bits are written as explicit masks.
The point formulas of csrc/edwards_kernels.cu (pt_add, pt_madd, pt_double,
the R-step scan, the doubling chain), its squaring chain and its copy of a
block's rows through shared memory are modelled on top and held to
utils/curve_host.py and to Python integers.

The constants the model uses are read out of the header itself, so the two
cannot drift apart.
"""

import random
import re
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dusk_blindbidproof_tpu_torch.utils import curve_host as host

P = host.P
HEADER = (
    Path(__file__).resolve().parents[1]
    / "dusk_blindbidproof_tpu_torch" / "csrc" / "fe25519.cuh"
).read_text()

NL10, ROW = 10, 21


def u32(x: int) -> int:
    assert 0 <= x < 1 << 32, f"32-bit word wrapped: {x}"
    return x


def u64(x: int) -> int:
    assert 0 <= x < 1 << 64, f"64-bit word wrapped: {x}"
    return x


def fe_bits(i):
    return 25 if i & 1 else 26


def fe_off(i):
    return (51 * i + 1) // 2


def fe_mask(i):
    return (1 << fe_bits(i)) - 1


def fe_limb_of(bit):
    return (2 * bit) // 51


def _header_d2():
    body = re.search(r"fe_d2\(\)\s*\{\s*return Fe\{\{([^}]*)\}\}", HEADER).group(1)
    return [int(t.strip().rstrip("u")) for t in body.split(",")]


def _header_two_p():
    m = re.search(
        r"fe_two_p\(int i\)\s*\{\s*return i == 0 \? (\w+) : \(\(i & 1\) \? (\w+) : (\w+)\);",
        HEADER,
    )
    first, odd, even = (int(t.rstrip("u"), 16) for t in m.groups())
    return [first if i == 0 else (odd if i & 1 else even) for i in range(NL10)]


D2 = _header_d2()
TWO_P = _header_two_p()


def value(x) -> int:
    return sum(v << fe_off(i) for i, v in enumerate(x))


# --- the header, function by function ---------------------------------------


def fe_from_words(words):
    """words: the row's 21 int32 limbs, each in [0, 8192]."""
    s, acc = [0] * ROW, 0
    for j in range(ROW):
        acc = u32(acc + words[j])
        s[j] = acc & 0x1FFF
        acc >>= 13
    x = [0] * NL10
    for i in range(NL10):
        j0, r = divmod(fe_off(i), 13)
        win = u64(s[j0] | (s[j0 + 1] << 13) | (s[j0 + 2] << 26))
        x[i] = ((win >> r) & 0xFFFFFFFF) & fe_mask(i)
    hi = u32((s[19] >> 8) | (s[20] << 5) | (acc << 18))
    x[0] = u32(x[0] + u32(19 * hi))
    x[1] = u32(x[1] + (x[0] >> 26))
    x[0] &= fe_mask(0)
    return x


fe_load = fe_load_row = fe_from_words  # the header's two ways to fetch the words


def fe_add(a, b):
    return [u32(a[i] + b[i]) for i in range(NL10)]


def fe_sub(a, b):
    return [u32(u32(a[i] + TWO_P[i]) - b[i]) for i in range(NL10)]


def fe_carry(a):
    x = list(a)
    for i in range(NL10 - 1):
        x[i + 1] = u32(x[i + 1] + (x[i] >> fe_bits(i)))
        x[i] &= fe_mask(i)
    x[0] = u32(x[0] + u32(19 * (x[9] >> 25)))
    x[9] &= fe_mask(9)
    x[1] = u32(x[1] + (x[0] >> 26))
    x[0] &= fe_mask(0)
    return x


def fe_column(x, k, total, carry):
    total = u64(total + carry)
    x[k] = (total & 0xFFFFFFFF) & fe_mask(k)
    return total >> fe_bits(k)


def fe_wrap(x, carry):
    low = u64(x[0] + u64(19 * carry))
    x[0] = (low & 0xFFFFFFFF) & fe_mask(0)
    x[1] = u32(x[1] + u32(low >> 26))


def fe_mul(a, b):
    b19 = [u32(19 * v) for v in b]
    a2 = [u32(2 * v) for v in a]
    x, carry = [0] * NL10, 0
    for k in range(NL10):
        total = 0
        for i in range(NL10):
            j = (k - i + NL10) % NL10
            u = a2[i] if (i & 1) and (j & 1) else a[i]
            v = b19[j] if i > k else b[j]
            total = u64(total + u * v)
        carry = fe_column(x, k, total, carry)
    fe_wrap(x, carry)
    return x


def fe_sqr(a):
    a19 = [u32(19 * v) for v in a]
    a2 = [u32(2 * v) for v in a]
    a4 = [u32(4 * v) for v in a]
    x, carry = [0] * NL10, 0
    for k in range(NL10):
        total = 0
        for i in range(NL10):
            j = (k - i + NL10) % NL10
            if i > j:
                continue
            odd = (i & 1) and (j & 1)
            if i == j:
                u = a2[i] if odd else a[i]
            else:
                u = a4[i] if odd else a2[i]
            v = a19[j] if i + j >= NL10 else a[j]
            total = u64(total + u * v)
        carry = fe_column(x, k, total, carry)
    fe_wrap(x, carry)
    return x


def fe_canon(a):
    q = u32(a[0] + 19) >> 26
    for i in range(1, NL10):
        q = u32(a[i] + q) >> fe_bits(i)
    x = list(a)
    x[0] = u32(x[0] + 19 * q)
    for i in range(NL10 - 1):
        x[i + 1] = u32(x[i + 1] + (x[i] >> fe_bits(i)))
        x[i] &= fe_mask(i)
    x[9] &= fe_mask(9)
    return x


def fe_to_words(a):
    """-> the row's 21 canonical 13-bit limbs."""
    h = fe_canon(a)
    s = [0] * ROW
    for j in range(ROW - 1):
        i = fe_limb_of(13 * j)
        sh = 13 * j - fe_off(i)
        win = u64(h[i] | ((h[i + 1] << fe_bits(i)) if i + 1 < NL10 else 0))
        s[j] = ((win >> sh) & 0xFFFFFFFF) & 0x1FFF
    return s


fe_store_canon = fe_store_row = fe_to_words  # the header's two ways to place the words


# --- csrc/edwards_kernels.cu: the point formulas on that core ---------------


def pt_finish(a, b, c, dd):
    e, f = fe_sub(b, a), fe_sub(dd, c)
    g, h = fe_add(dd, c), fe_add(b, a)
    return [fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), fe_mul(e, h)]


def pt_add(p, q_rows):
    px, py, pz, pt = p
    c = fe_mul(fe_mul(pt, fe_load(q_rows[3])), D2)
    dd = fe_mul(fe_add(pz, pz), fe_load(q_rows[2]))
    qx, qy = fe_load(q_rows[0]), fe_load(q_rows[1])
    qm, qp = fe_sub(qy, qx), fe_add(qy, qx)
    a = fe_mul(fe_sub(py, px), qm)
    b = fe_mul(fe_add(py, px), qp)
    return pt_finish(a, b, c, dd)


def pt_madd(p, q_rows):
    px, py, pz, pt = p
    a = fe_mul(fe_sub(py, px), fe_load(q_rows[0]))
    b = fe_mul(fe_add(py, px), fe_load(q_rows[1]))
    c = fe_mul(pt, fe_load(q_rows[2]))
    dd = fe_carry(fe_add(pz, pz))
    return pt_finish(a, b, c, dd)


def pt_identity():
    one, zero = [1] + [0] * 9, [0] * NL10
    return [zero, one, one, zero]


def scan(step, items, R):
    """point_scan_kernel for one block: prefixes as canonical 21-limb rows."""
    acc, out = pt_identity(), []
    for r in range(R):
        acc = step(acc, items[r])
        out.append([fe_store_canon(c) for c in acc])
    return out


def pt_double(p, with_t=True):
    px, py, pz, _ = p
    s = fe_sqr(fe_add(px, py))
    a, b = fe_sqr(px), fe_sqr(py)
    h = fe_add(a, b)
    e = fe_carry(fe_sub(h, s))
    g = fe_sub(a, b)
    zz = fe_sqr(pz)
    f = fe_carry(fe_add(fe_add(zz, zz), g))
    t = fe_mul(e, h) if with_t else [0] * NL10
    return [fe_mul(e, f), fe_mul(g, h), fe_mul(f, g), t]


def double_chain(point_rows, windows, steps):
    """double_chain_kernel for one thread: a canonical point a window."""
    acc = [fe_load(r) for r in point_rows]
    out = [[fe_store_canon(c) for c in acc]]
    for _ in range(1, windows):
        for _ in range(1, steps):
            acc = pt_double(acc, with_t=False)
        acc = pt_double(acc)
        out.append([fe_store_canon(c) for c in acc])
    return out


def sqr_chain(words, k):
    """sqr_chain_kernel for one thread."""
    z = fe_load_row(words)
    for _ in range(k):
        z = fe_sqr(z)
    return fe_store_row(z)


# the row kernels' tile: 128 rows of 21 words through shared memory

ROW_THREADS = 128
TILE_WORDS = ROW_THREADS * ROW


def tile_mis(addr):
    """addr: a byte address, a multiple of 4."""
    return (addr >> 2) & 3


def _tile_split(addr, nwords):
    mis = tile_mis(addr)
    head = (4 - mis) & 3
    nvec = (nwords - head) >> 2
    return mis, head, nvec, head + 4 * nvec


def tile_load(memory, addr, nwords):
    """memory: word-addressed list standing for device memory; the tile
    starts at byte `addr`.  Vector accesses assert their 16-byte alignment on
    both sides.  -> the shared array (TILE_WORDS + 4 words, None = unwritten)."""
    sh = [None] * (TILE_WORDS + 4)
    g = addr >> 2
    mis, head, nvec, tail = _tile_split(addr, nwords)
    for t in range(ROW_THREADS):
        if t < head:
            sh[mis + t] = memory[g + t]
        for k in range(t, nvec, ROW_THREADS):
            assert (addr + 4 * (head + 4 * k)) % 16 == 0 and (mis + head + 4 * k) % 4 == 0
            for c in range(4):
                sh[mis + head + 4 * k + c] = memory[g + head + 4 * k + c]
        if t < nwords - tail:
            sh[mis + tail + t] = memory[g + tail + t]
    return sh


def tile_store(memory, addr, sh, nwords):
    g = addr >> 2
    mis, head, nvec, tail = _tile_split(addr, nwords)
    for t in range(ROW_THREADS):
        if t < head:
            memory[g + t] = sh[mis + t]
        for k in range(t, nvec, ROW_THREADS):
            assert (addr + 4 * (head + 4 * k)) % 16 == 0 and (mis + head + 4 * k) % 4 == 0
            for c in range(4):
                memory[g + head + 4 * k + c] = sh[mis + head + 4 * k + c]
        if t < nwords - tail:
            memory[g + tail + t] = sh[mis + tail + t]


def mul_rows_block(memory, a_addr, b_addr, out_addr, rows, elem_load, elem_mul, elem_store):
    """mul_rows_kernel for one block of `rows` <= 128 rows."""
    ta = tile_load(memory, a_addr, rows * ROW)
    tb = tile_load(memory, b_addr, rows * ROW)
    z = []
    for t in range(rows):
        ra, rb = tile_mis(a_addr) + t * ROW, tile_mis(b_addr) + t * ROW
        z.append(elem_mul(elem_load(ta[ra:ra + ROW]), elem_load(tb[rb:rb + ROW])))
    for t in range(rows):
        ro = tile_mis(out_addr) + t * ROW
        ta[ro:ro + ROW] = elem_store(z[t])
    tile_store(memory, out_addr, ta, rows * ROW)


# --- helpers ----------------------------------------------------------------


def limbs13(v: int, n=ROW):
    return [(v >> (13 * j)) & 0x1FFF for j in range(n)]


def from_limbs13(s) -> int:
    return sum(v << (13 * j) for j, v in enumerate(s))


def in_class_r(x) -> bool:
    return (
        x[0] < 1 << 26
        and x[1] < (1 << 25) + (1 << 18)
        and all(x[i] <= fe_mask(i) for i in range(2, NL10))
    )


ALL_8192 = [8192] * ROW
EDGES = {
    "0": limbs13(0),
    "1": limbs13(1),
    "p-1": limbs13(P - 1),
    "p": limbs13(P),
    "p+1": limbs13(P + 1),
    "2^255-1": limbs13(2**255 - 1),
    "2^255": limbs13(2**255),
    "2^273-1": limbs13(2**273 - 1),
    "all-8192": ALL_8192,
}
# the widest operands fe_mul and fe_sqr accept (the header's 3 R + 2^19)
WIDEST = [3 * (1 << fe_bits(i)) + (1 << 19) - 1 for i in range(NL10)]

rows = st.lists(st.integers(0, 8192), min_size=ROW, max_size=ROW)


# --- the field --------------------------------------------------------------


def test_header_constants():
    assert value(D2) == 2 * host.D % P
    assert value(TWO_P) == 2 * P
    assert [fe_off(i) for i in range(NL10)] == [0, 26, 51, 77, 102, 128, 153, 179, 204, 230]
    for bit in range(255):
        i = fe_limb_of(bit)
        assert fe_off(i) <= bit < fe_off(i) + fe_bits(i)
    # every limb of 2 p covers the class-R bound, so fe_sub cannot go negative
    assert TWO_P[0] >= 1 << 26 and TWO_P[1] >= (1 << 25) + (1 << 18)
    assert all(TWO_P[i] >= fe_mask(i) for i in range(2, NL10))


@pytest.mark.parametrize("name", list(EDGES))
def test_load_and_store_edges(name):
    words = EDGES[name]
    x = fe_load(words)
    assert in_class_r(x)
    assert value(x) % P == from_limbs13(words) % P
    out = fe_store_canon(x)
    assert out == limbs13(from_limbs13(words) % P) and out[20] == 0


@pytest.mark.parametrize("a", list(EDGES))
@pytest.mark.parametrize("b", list(EDGES))
def test_ops_on_edge_pairs(a, b):
    va, vb = from_limbs13(EDGES[a]), from_limbs13(EDGES[b])
    x, y = fe_load(EDGES[a]), fe_load(EDGES[b])
    prod = fe_mul(x, y)
    assert in_class_r(prod) and value(prod) % P == va * vb % P
    assert value(prod) < 2 * P
    assert from_limbs13(fe_store_canon(prod)) == va * vb % P
    assert value(fe_add(x, y)) % P == (va + vb) % P
    assert value(fe_sub(x, y)) % P == (va - vb) % P
    # the widest products the point formulas form: (x - y)(y - x), (x + y)^2
    d, e, s = fe_sub(x, y), fe_sub(y, x), fe_add(x, y)
    assert value(fe_mul(d, e)) % P == -((va - vb) ** 2) % P
    assert value(fe_mul(s, d)) % P == (va * va - vb * vb) % P
    sq = fe_sqr(d)
    assert in_class_r(sq) and value(sq) % P == (va - vb) ** 2 % P
    carried = fe_carry(fe_add(s, s))
    assert in_class_r(carried) and value(carried) % P == 2 * (va + vb) % P


def test_widest_operands_do_not_wrap():
    # the model's u32 / u64 asserts are the check
    prod = fe_mul(WIDEST, WIDEST)
    assert in_class_r(prod) and value(prod) % P == value(WIDEST) ** 2 % P
    sq = fe_sqr(WIDEST)
    assert sq == prod or value(sq) % P == value(prod) % P
    assert in_class_r(fe_carry([(1 << 32) - (1 << 7) - 1] * NL10))
    r_max = [(1 << 26) - 1, (1 << 25) + (1 << 18) - 1] + [fe_mask(i) for i in range(2, NL10)]
    assert all(v <= w for v, w in zip(fe_sub(r_max, [0] * NL10), WIDEST))
    assert value(r_max) < 2 * P
    assert from_limbs13(fe_store_canon(r_max)) == value(r_max) % P


@settings(max_examples=200, deadline=None)
@given(rows, rows)
def test_field_ops_random_rows(wa, wb):
    va, vb = from_limbs13(wa), from_limbs13(wb)
    x, y = fe_load(wa), fe_load(wb)
    assert in_class_r(x) and value(x) % P == va % P
    assert fe_store_canon(x) == limbs13(va % P)
    prod = fe_mul(fe_sub(x, y), fe_add(x, y))
    assert in_class_r(prod) and value(prod) % P == (va * va - vb * vb) % P
    assert fe_store_canon(prod) == limbs13((va * va - vb * vb) % P)
    assert value(fe_sqr(fe_sub(y, x))) % P == (va - vb) ** 2 % P
    assert value(fe_mul(fe_mul(x, D2), y)) % P == 2 * host.D * va * vb % P


@settings(max_examples=200, deadline=None)
@given(st.integers(0, 2 * P - 1))
def test_canon_below_two_p(v):
    # any limb split of v that fe_canon's precondition allows: strict limbs
    # with the excess over 2^255 left in limb 9's bit 25
    x = [(v >> fe_off(i)) & fe_mask(i) for i in range(NL10)]
    x[9] = v >> fe_off(9)
    assert value(x) == v
    assert from_limbs13(fe_store_canon(x)) == v % P


# --- the point formulas -----------------------------------------------------


def _host_points(seed, n):
    rng = random.Random(seed)
    return [host.ED25519_BASEPOINT.scalar_mul(rng.randrange(1, host.L)) for _ in range(n)]


def _ext_rows(pt, scale=1):
    """Extended rows of a host point, projectively rescaled, as 21-limb rows."""
    return [limbs13(c * scale % P) for c in (pt.X, pt.Y, pt.Z, pt.T)]


def _niels_rows(pt):
    x, y = pt.affine()
    return [limbs13((y - x) % P), limbs13((y + x) % P), limbs13(2 * host.D * x * y % P),
            limbs13(0)]


def _affine_of_rows(rows21):
    X, Y, Z, T = (from_limbs13(r) for r in rows21)
    assert all(c < P for c in (X, Y, Z, T)), "stored rows must be canonical"
    assert X * Y % P == Z * T % P
    return host.EdwardsPoint(X, Y, Z, T).affine()


def _load_point(rows21):
    return [fe_load(r) for r in rows21]


IDENTITY_ROWS = [limbs13(0), limbs13(1), limbs13(1), limbs13(0)]
IDENTITY_NIELS = [limbs13(1), limbs13(1), limbs13(0), limbs13(0)]


@pytest.mark.parametrize("seed", range(6))
def test_pt_add_model_vs_host(seed):
    p, q = _host_points(100 + seed, 2)
    if seed == 4:
        q = p  # doubling through the unified formula
    got = pt_add(_load_point(_ext_rows(p, 3 + seed)), _ext_rows(q, 7))
    assert _affine_of_rows([fe_store_canon(c) for c in got]) == (p + q).affine()
    if seed == 5:  # identity on either side
        got = pt_add(_load_point(IDENTITY_ROWS), _ext_rows(q))
        assert _affine_of_rows([fe_store_canon(c) for c in got]) == q.affine()
        got = pt_add(_load_point(_ext_rows(p)), IDENTITY_ROWS)
        assert _affine_of_rows([fe_store_canon(c) for c in got]) == p.affine()


@pytest.mark.parametrize("seed", range(6))
def test_pt_madd_model_vs_host(seed):
    p, q = _host_points(200 + seed, 2)
    if seed == 4:
        q = p
    got = pt_madd(_load_point(_ext_rows(p, 5 + seed)), _niels_rows(q))
    assert _affine_of_rows([fe_store_canon(c) for c in got]) == (p + q).affine()
    if seed == 5:
        got = pt_madd(_load_point(_ext_rows(p)), IDENTITY_NIELS)
        assert _affine_of_rows([fe_store_canon(c) for c in got]) == p.affine()
        got = pt_madd(pt_identity(), _niels_rows(q))
        assert _affine_of_rows([fe_store_canon(c) for c in got]) == q.affine()


@pytest.mark.parametrize("leaf", ["madd", "add"])
def test_scan_32_steps_model_vs_host(leaf):
    pts = _host_points(300, 32)
    pts[5] = host.EdwardsPoint.identity()
    pts[9] = pts[8]
    if leaf == "madd":
        items = [_niels_rows(p) for p in pts]
        items[5] = IDENTITY_NIELS
        prefixes = scan(pt_madd, items, 32)
    else:
        items = [_ext_rows(p, 11 + i) for i, p in enumerate(pts)]
        prefixes = scan(pt_add, items, 32)
    run = host.EdwardsPoint.identity()
    for r, p in enumerate(pts):
        run = run + p
        assert _affine_of_rows(prefixes[r]) == run.affine(), r


@pytest.mark.parametrize("leaf", ["madd", "add"])
def test_point_ops_on_all_8192_rows(leaf):
    """Rows of all-8192 limbs are no curve point; the formulas are still
    polynomial identities mod p, which is what the kernels are held to."""
    v = from_limbs13(ALL_8192) % P
    p = _load_point([ALL_8192] * 4)
    if leaf == "madd":
        got = pt_madd(p, [ALL_8192] * 4)
        a, b, c, dd = 0, 2 * v * v, v * v, 2 * v
    else:
        got = pt_add(p, [ALL_8192] * 4)
        a, b, c, dd = 0, 4 * v * v, 2 * host.D * v * v, 2 * v * v
    e, f, g, h = b - a, dd - c, dd + c, b + a
    want = [e * f % P, g * h % P, f * g % P, e * h % P]
    assert [from_limbs13(fe_store_canon(x)) for x in got] == want


# --- K4 and the doubling chain -----------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_pt_double_model_vs_host(seed):
    (p,) = _host_points(400 + seed, 1)
    rows21 = _ext_rows(p, 3 + seed)
    if seed == 4:
        p, rows21 = host.EdwardsPoint.identity(), IDENTITY_ROWS
    if seed == 5:  # T is not read
        rows21 = rows21[:3] + [ALL_8192]
    got = pt_double(_load_point(rows21))
    assert all(in_class_r(c) for c in got)
    assert _affine_of_rows([fe_store_canon(c) for c in got]) == (p + p).affine()
    without_t = pt_double(_load_point(rows21), with_t=False)
    assert without_t[:3] == got[:3] and without_t[3] == [0] * NL10


def test_pt_double_on_widest_rows():
    """All-8192 rows and the largest class-R limbs: the u32 / u64 asserts hold
    through every intermediate, and the result is the formula's value mod p."""
    r_max = [(1 << 26) - 1, (1 << 25) + (1 << 18) - 1] + [fe_mask(i) for i in range(2, NL10)]
    for p in (_load_point([ALL_8192] * 4), [r_max] * 4):
        x = y = z = value(p[0]) % P
        a, b, c = x * x, y * y, 2 * z * z
        h, g = a + b, a - b
        e, f = h - (x + y) ** 2, c + g
        want = [e * f % P, g * h % P, f * g % P, e * h % P]
        assert [from_limbs13(fe_store_canon(v)) for v in pt_double(p)] == want


@pytest.mark.parametrize("windows,steps", [(2, 13), (20, 13), (3, 1), (1, 13)],
                         ids=["13-steps", "247-steps", "steps-1", "one-window"])
def test_double_chain_model_vs_host(windows, steps):
    (p,) = _host_points(500 + windows, 1)
    rows21 = _ext_rows(p, 9)
    rows21[3] = limbs13(from_limbs13(rows21[3]) + P)  # window 0 is stored canonical
    out = double_chain(rows21, windows, steps)
    assert len(out) == windows
    for w, stored in enumerate(out):
        assert _affine_of_rows(stored) == p.scalar_mul(1 << (steps * w)).affine(), w


# --- the squaring chain -------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 5, 50, 100])
@pytest.mark.parametrize("name", ["0", "1", "p-1", "p", "2^273-1", "all-8192"])
def test_sqr_chain_model_edges(name, k):
    v = from_limbs13(EDGES[name])
    assert from_limbs13(sqr_chain(EDGES[name], k)) == pow(v, 2**k, P)


@settings(max_examples=50, deadline=None)
@given(rows, st.sampled_from([2, 3, 10, 20]))
def test_sqr_chain_model_random_rows(words, k):
    assert sqr_chain(words, k) == limbs13(pow(from_limbs13(words), 2**k, P))


# --- the row tile --------------------------------------------------------------


@pytest.mark.parametrize("rows_in_block", [128, 5, 1])
@pytest.mark.parametrize("mis", range(4))
def test_tile_copy_at_every_alignment(mis, rows_in_block):
    """Every word of the tile arrives where thread t reads its row, nothing
    else is touched, and every vector access is aligned on both sides."""
    rng = random.Random(10 * mis + rows_in_block)
    nwords = rows_in_block * ROW
    memory = [rng.randrange(1 << 31) for _ in range(nwords + 16)]
    addr = 4 * (4 + mis)  # the tile starts `mis` words past a 16-byte boundary
    sh = tile_load(memory, addr, nwords)
    g = addr >> 2
    assert tile_mis(addr) == mis
    assert sh[mis:mis + nwords] == memory[g:g + nwords]
    assert all(w is None for w in sh[:mis] + sh[mis + nwords:])
    for out_mis in range(4):
        target = [-1] * (nwords + 16)
        out_addr = 4 * (8 + out_mis)
        shifted = [None] * (TILE_WORDS + 4)
        shifted[out_mis:out_mis + nwords] = sh[mis:mis + nwords]
        tile_store(target, out_addr, shifted, nwords)
        o = out_addr >> 2
        assert target[o:o + nwords] == memory[g:g + nwords]
        assert set(target[:o] + target[o + nwords:]) == {-1}


@pytest.mark.parametrize("a_mis,b_mis,out_mis", [(0, 0, 0), (1, 0, 0), (0, 3, 2), (2, 1, 3)])
def test_mul_rows_block_model_mod_p(a_mis, b_mis, out_mis):
    rng = random.Random(7)
    rows_in_block = 9
    nwords = rows_in_block * ROW
    a = [[rng.randrange(8193) for _ in range(ROW)] for _ in range(rows_in_block)]
    b = [[rng.randrange(8193) for _ in range(ROW)] for _ in range(rows_in_block)]
    a[0], b[0], b[1] = ALL_8192, ALL_8192, limbs13(0)
    size = 3 * (nwords + 8)
    memory = [-1] * size
    a_addr, b_addr = 4 * (4 + a_mis), 4 * (nwords + 12 + b_mis)
    out_addr = 4 * (2 * nwords + 20 + out_mis)
    memory[a_addr >> 2:(a_addr >> 2) + nwords] = [w for r in a for w in r]
    memory[b_addr >> 2:(b_addr >> 2) + nwords] = [w for r in b for w in r]
    before = list(memory)
    mul_rows_block(memory, a_addr, b_addr, out_addr, rows_in_block,
                   fe_load_row, fe_mul, fe_store_row)
    o = out_addr >> 2
    for t in range(rows_in_block):
        want = from_limbs13(a[t]) * from_limbs13(b[t]) % P
        assert memory[o + 21 * t:o + 21 * t + 21] == limbs13(want)
    assert memory[:o] == before[:o] and memory[o + nwords:] == before[o + nwords:]
