"""The CUDA kernels (K1 mul_rows and its squaring chain, K3 add, K4 double
and its doubling chain, the R-step scans madd_scan (K2 leaf), add_scan,
add_total, Ristretto compression, and the BlindBid witness's mimc_chain and
witness_fanout) against their plain PyTorch versions.

This file imports neither jax nor the JAX package, so it also runs on a GPU
machine without them:

    python -m pytest --noconftest tests/test_torch_kernels.py

The kernel tests need a card (marker `cuda`) and skip without one; the
test that runs every wrapper on cuda:1 while cuda:0 is current needs two.
The kernels return canonical limbs, so each is held to `canon(plain)`
exactly, on random rows, all-8192 rows (the largest input the plain engine
hands over, limb 20 included) and identity points.  Compression, kernel and
plain version alike, is held byte for byte to curve_host's
`ristretto_compress` on sets of points chosen for its branches.  Without a card, a
stand-in for the current device holds every launch to a guard of its
operands' card.
"""

import numpy as np
import pytest
import torch

from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb
from dusk_blindbidproof_tpu_torch.utils import curve_host as host

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


# ---------------------------------------------------------------------------
# Ristretto compression
# ---------------------------------------------------------------------------

# the 4-torsion of the curve: P + T has P's Ristretto encoding for each T
TORSION4 = [host.EdwardsPoint(0, 1, 1, 0), host.EdwardsPoint(host.SQRT_M1, 0, 1, 0),
            host.EdwardsPoint(0, host.P - 1, 1, 0),
            host.EdwardsPoint(host.P - host.SQRT_M1, 0, 1, 0)]


def _basepoint_multiples(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [host.ED25519_BASEPOINT.scalar_mul(int(k)) for k in rng.integers(1, 2**62, n)]


def _rows_of(points, scale: int = 1) -> torch.Tensor:
    """Host points -> [n, 4, NLIMBS] rows, each coordinate times `scale`
    (the same point in other projective coordinates)."""
    return torch.from_numpy(np.stack([
        np.stack([limb.int_to_limbs(c * scale % host.P) for c in (p.X, p.Y, p.Z, p.T)])
        for p in points]))


def _host_encodings(rows: torch.Tensor) -> list[bytes]:
    """curve_host's compression of every [4, NLIMBS] row, read as integers."""
    return [host.ristretto_compress(host.EdwardsPoint(*(limb.limbs_to_int(c) for c in row)))
            for row in rows.reshape(-1, 4, limb.NLIMBS).cpu().numpy()]


def _encoding_bytes(words: torch.Tensor) -> list[bytes]:
    return [e.tobytes() for e in words.cpu().numpy().reshape(-1, 8).view(np.uint8)]


def _compress_branches(pt) -> tuple:
    """(rotate, Y negated, s negated) as curve_host.ristretto_compress takes them."""
    P = host.P
    X, Y, Z, T = pt.X % P, pt.Y % P, pt.Z % P, pt.T % P
    u1, u2 = (Z + Y) * (Z - Y) % P, X * Y % P
    inv = host.invsqrt(u1 * u2 * u2 % P)[1]
    den1, den2 = inv * u1 % P, inv * u2 % P
    z_inv = den1 * den2 * T % P
    rotate = host._is_neg(T * z_inv)
    if rotate:
        X, Y, den = Y * host.SQRT_M1 % P, X * host.SQRT_M1 % P, den1 * host.INVSQRT_A_MINUS_D
    else:
        den = den2
    flip = host._is_neg(X * z_inv)
    Y = -Y % P if flip else Y
    return rotate, flip, host._is_neg(den * (Z - Y))


def _branch_points() -> list:
    """Points P + T, T in the 4-torsion, that take each of compression's
    branches: rotate or not, times Y negated or not, times s negated or not."""
    found = {}
    for k in range(1, 200):
        base = host.ED25519_BASEPOINT.scalar_mul(k)
        for t in TORSION4:
            pt = base + t
            found.setdefault(_compress_branches(pt), pt)
        if len(found) == 8:
            return [found[key] for key in sorted(found)]
    raise AssertionError(f"branches never taken: {sorted(found)}")


def compress_set(name: str) -> torch.Tensor:
    """[n, 4, NLIMBS] rows of one set that compression is held to."""
    if name == "add-outputs":  # Z != 1: the canonical output of K3's plain version
        p, q = _basepoint_multiples(31, 12), _basepoint_multiples(32, 12)
        return limb.canon(limb.FP, fused.add_ref(_rows_of(p, 3), _rows_of(q, 5)))
    if name == "identity":
        return torch.cat([edwards.identity((3,)), _rows_of([host.EdwardsPoint(0, 1, 1, 0)], 7)])
    if name == "torsion-representatives":  # four rows, one encoding
        (p,) = _basepoint_multiples(33, 1)
        return _rows_of([p + t for t in TORSION4], 11)
    if name == "branches":
        return _rows_of(_branch_points(), 13)
    if name == "all-8192":  # no curve point; the formula mod p all the same
        return torch.full((2, 4, limb.NLIMBS), 8192, dtype=torch.int32)
    raise KeyError(name)


COMPRESS_SETS = ("add-outputs", "identity", "torsion-representatives", "branches", "all-8192")


def test_compress_sets_take_what_they_are_named_for():
    torsion = _host_encodings(compress_set("torsion-representatives"))
    assert len(set(torsion)) == 1
    assert set(_host_encodings(compress_set("identity"))) == {bytes(32)}
    branches = {_compress_branches(pt) for pt in _branch_points()}
    assert len(branches) == 8
    assert not torch.all(compress_set("add-outputs")[:, 2] == torch.from_numpy(
        limb.int_to_limbs(1)))


@pytest.mark.parametrize("name", COMPRESS_SETS)
def test_compress_ref_matches_host(name):
    rows = compress_set(name)
    got = fused.compress_ref(rows)
    assert got.shape == (rows.shape[0], 8) and got.dtype == torch.int32
    assert _encoding_bytes(got) == _host_encodings(rows)


@pytest.mark.cuda
@pytest.mark.parametrize("name", COMPRESS_SETS)
def test_compress_kernel_matches_host(cuda, name):
    rows = compress_set(name)
    before = fused.LAUNCHES["compress"]
    got = fused.compress(rows.to(cuda))
    torch.cuda.synchronize()
    assert fused.LAUNCHES["compress"] == before + 1
    assert got.shape == (rows.shape[0], 8) and got.dtype == torch.int32
    assert _encoding_bytes(got) == _host_encodings(rows)
    assert torch.equal(got.cpu(), fused.compress_ref(rows))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(256, 8), (256, 2), (16, 2)],
                         ids=["commitments-256", "ipa-round-256", "ipa-round-16"])
def test_compress_kernel_at_the_main_path_shapes(cuda, shape):
    """[B, k] points as the prover hands them over: sums of basepoint
    multiples made on the card by K3, so that Z is no longer 1."""
    n = shape[0] * shape[1]
    pts = _rows_of(_basepoint_multiples(34, 64)).to(cuda)
    idx = torch.arange(n, device=cuda)
    rows = fused.add(pts[idx % 64], pts[(7 * idx // 64 + idx) % 64]).view(*shape, 4, limb.NLIMBS)
    before = fused.LAUNCHES["compress"]
    got = fused.compress(rows)
    torch.cuda.synchronize()
    assert fused.LAUNCHES["compress"] == before + 1
    assert got.shape == (*shape, 8)
    assert _encoding_bytes(got) == _host_encodings(rows)


@pytest.mark.cuda
def test_compress_refuses_what_the_kernel_does_not_take(cuda):
    p = _rows(25, (4, 8, 4, limb.NLIMBS)).to(cuda)
    before = fused.LAUNCHES["compress"]
    with pytest.raises(ValueError):
        fused.compress(p[..., :20].contiguous())  # not [..., 4, 21] points
    with pytest.raises(ValueError):
        fused.compress(p.transpose(0, 1))  # not contiguous
    with pytest.raises(TypeError):
        fused.compress(p.long())
    shifted = torch.zeros(limb.NLIMBS + p.numel(), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # contiguous, one 84-byte row off the 16-byte grid
        fused.compress(shifted[limb.NLIMBS :].view(p.shape))
    assert fused.LAUNCHES["compress"] == before
    ok = fused.compress(*fused.kernel_operands(p.transpose(0, 1)))
    torch.cuda.synchronize()
    assert fused.LAUNCHES["compress"] == before + 1
    assert torch.equal(ok.transpose(0, 1).cpu(), fused.compress_ref(p.cpu()))


def _witness_operands():
    """Random limbs in [0, 8192] (any value, read mod l) as the committed
    values and publics of 3 proofs of 4 bids, the MiMC constants and n_pad."""
    from dusk_blindbidproof_tpu_torch.models import blindbid

    v, publics = _rows(25, (3, 8, limb.NLIMBS)), _rows(26, (3, 7, limb.NLIMBS))
    v[:, 4:] = 0
    v[:, 5, 0] = 1  # one toggle a proof
    return v, publics, blindbid.mimc_constants_limbs(torch.device("cpu")), 2048


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
    assert torch.equal(fused.compress(p), fused.compress_ref(p))
    from dusk_blindbidproof_tpu_torch.models import blindbid

    v, publics, consts, n_pad = _witness_operands()
    assert torch.equal(blindbid.witness_wires(v, publics, consts, n_pad),
                       blindbid.witness_wires_ref(v, publics, consts, n_pad))
    items = _rows(13, (2, 12, 4, limb.NLIMBS))
    for name, (kern, ref, _) in SCAN_KERNELS.items():
        for g, w in zip(_as_tuple(kern(items, 4)), _as_tuple(ref(items, 4))):
            assert torch.equal(g, w), name
    with pytest.raises(ValueError):
        fused.add_total(items, 5)  # 12 items are not whole blocks of 5
    assert fused.launch_counts() == before
    ops = fused.kernel_operands(a, b)
    assert ops[0] is a and ops[1] is b


# ---------------------------------------------------------------------------
# Every launch is made on its operands' card, whichever card is current
# ---------------------------------------------------------------------------

# the library entry each kernel name launches through
ENTRIES = {"mul_rows_fp": "bb_mul_rows", "mul_rows_fl": "bb_mul_rows",
           "sqr_chain": "bb_sqr_chain", "add": "bb_point_add", "double": "bb_point_double",
           "double_chain": "bb_double_chain", "madd_scan": "bb_point_scan",
           "add_scan": "bb_point_scan", "add_total": "bb_point_scan", "compress": "bb_compress",
           "mimc_chain": "bb_mimc_chain", "witness_fanout": "bb_witness_fanout"}


class _Cards:
    """A stand-in for the CUDA runtime's per-thread current device:
    `guard(device)` replaces torch.cuda.device, `stream(device)`
    torch.cuda.current_stream (the handle names its card), and `lib(rc)` is
    a library whose every entry records the current card and its arguments
    and returns rc."""

    def __init__(self, current: int):
        self.current = current
        self.calls = []

    def guard(self, device):
        cards = self

        class Guard:
            def __enter__(self):
                self.outer, cards.current = cards.current, torch.device(device).index

            def __exit__(self, *exc_info):
                cards.current = self.outer

        return Guard()

    @staticmethod
    def stream(device):
        class Stream:
            cuda_stream = 1000 + torch.device(device).index

        return Stream()

    def lib(self, rc: int = 0):
        cards = self

        class Lib:
            def __getattr__(self, entry):
                def fn(*args):
                    cards.calls.append((entry, cards.current, args))
                    return rc

                return fn

        return Lib()


@pytest.mark.parametrize("card, current", [(1, 0), (0, 1)], ids=["cuda:1-from-0", "cuda:0-from-1"])
@pytest.mark.parametrize("name", fused.KERNELS)
def test_launch_is_made_inside_a_guard_of_its_card(monkeypatch, name, card, current):
    """Each kernel name's launch runs while its operands' card is current,
    with that card's stream as the last argument; the caller's card is
    current again after it."""
    cards = _Cards(current)
    monkeypatch.setattr(torch.cuda, "device", cards.guard)
    monkeypatch.setattr(torch.cuda, "current_stream", cards.stream)
    monkeypatch.setattr(fused, "_ready", lambda device: cards.lib())
    monkeypatch.setattr(fused, "LAUNCHES", dict.fromkeys(fused.KERNELS, 0))
    fused._launch(name, ENTRIES[name], torch.device("cuda", card), 11, 22)
    assert cards.calls == [(ENTRIES[name], card, (11, 22, 1000 + card))]
    assert cards.current == current
    assert fused.launch_counts() == {k: int(k == name) for k in fused.KERNELS}


def test_refused_launch_raises_counts_nothing_and_leaves_the_guard(monkeypatch):
    cards = _Cards(0)
    monkeypatch.setattr(torch.cuda, "device", cards.guard)
    monkeypatch.setattr(torch.cuda, "current_stream", cards.stream)
    monkeypatch.setattr(fused, "_ready", lambda device: cards.lib(rc=700))
    monkeypatch.setattr(fused, "LAUNCHES", dict.fromkeys(fused.KERNELS, 0))
    with pytest.raises(fused.KernelError, match="cudaError 700"):
        fused._launch("add", "bb_point_add", torch.device("cuda", 1), 1, 2, 3, 4)
    assert [(entry, card) for entry, card, _ in cards.calls] == [("bb_point_add", 1)]
    assert cards.current == 0
    assert fused.launch_counts() == dict.fromkeys(fused.KERNELS, 0)


@pytest.fixture
def second_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more NVIDIA GPUs")
    return torch.device("cuda", 1)


def _wrapper_cases(name):
    """(kernel call, plain call, the modulus its output is canonical in, or
    None for encodings) of one wrapper, on CPU operands."""
    rows, rows2 = _rows(21, (300, limb.NLIMBS)), _rows(24, (300, limb.NLIMBS))
    pts, other = _rows(22, (3, 64, 4, limb.NLIMBS)), _rows(23, (3, 64, 4, limb.NLIMBS))
    pts[0, 1] = edwards.identity()
    if name.startswith("mul_rows"):
        ctx = limb.FP if name == "mul_rows_fp" else limb.FL
        return (lambda d: fused.mul_rows(ctx, rows.to(d), rows2.to(d)),
                lambda: fused.mul_rows_ref(ctx, rows, rows2), ctx)
    if name == "sqr_chain":
        return (lambda d: fused.sqr_chain(limb.FP, rows.to(d), 5),
                lambda: fused.sqr_chain_ref(limb.FP, rows, 5), limb.FP)
    if name == "add":
        return lambda d: fused.add(pts.to(d), other.to(d)), lambda: fused.add_ref(pts, other), limb.FP
    if name == "double":
        return lambda d: fused.double(pts.to(d)), lambda: fused.double_ref(pts), limb.FP
    if name == "double_chain":
        return (lambda d: fused.double_chain(pts.to(d), 3, 2),
                lambda: fused.double_chain_ref(pts, 3, 2), limb.FP)
    if name == "compress":
        return lambda d: fused.compress(pts.to(d)), lambda: fused.compress_ref(pts), None
    if name in ("mimc_chain", "witness_fanout"):
        from dusk_blindbidproof_tpu_torch.models import blindbid

        v, publics, consts, n_pad = _witness_operands()
        return (lambda d: blindbid.witness_wires(v.to(d), publics.to(d), consts.to(d), n_pad),
                lambda: blindbid.witness_wires_ref(v, publics, consts, n_pad), None)
    kern, ref, _ = SCAN_KERNELS[name]
    return lambda d: kern(pts.to(d), 32), lambda: ref(pts, 32), limb.FP


@pytest.mark.cuda
@pytest.mark.parametrize("name", fused.KERNELS)
def test_wrapper_runs_on_a_card_that_is_not_current(second_card, name):
    """Every wrapper on cuda:1 while cuda:0 is current: exact against
    canon(plain), one launch, and cuda:0 still current after it."""
    kern, ref, ctx = _wrapper_cases(name)
    torch.cuda.set_device(0)
    before = fused.LAUNCHES[name]
    got = _as_tuple(kern(second_card))
    torch.cuda.synchronize(second_card)
    assert torch.cuda.current_device() == 0
    assert fused.LAUNCHES[name] == before + 1
    want = [w if ctx is None else limb.canon(ctx, w) for w in _as_tuple(ref())]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device == second_card
        assert torch.equal(g.cpu(), w)
