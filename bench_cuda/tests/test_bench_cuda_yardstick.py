"""The yardstick's arithmetic: the traffic, the statistics, the roofline
counts, the reference's curve arithmetic and its prover.  CPU only."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from bench_cuda import harness, roofline, traffic
from bench_cuda.reference import circuits, msm, prove, verify
from bench_cuda.reference.curve import ED25519_BASEPOINT, L


@pytest.mark.parametrize("seed", [0, 12345, 2**31 + 77, 2**40 + 3])
def test_bidders_repeat_for_a_seed_and_differ_for_another(seed):
    a = traffic.bidders(seed, "sessions", 6, 4)
    assert a == traffic.bidders(seed, "sessions", 6, 4)
    assert a != traffic.bidders(seed + 1, "sessions", 6, 4)
    assert a != traffic.bidders(seed, "warm", 6, 4)
    for b in a:
        assert b["pub_list"][b["toggle"]] == circuits.mimc_hash(
            b["d"], circuits.mimc_hash(b["k"], 0))
        assert b["y"] * b["y_inv"] % L == 1


def test_the_rate_moves_with_a_stall():
    # 10 trips of 256 proofs, one of them 3 s longer
    trips = [2.0] * 10
    assert harness.rate(2560, 0.0, sum(trips)) == 128.0
    trips[4] += 3.0
    assert harness.rate(2560, 0.0, sum(trips)) == pytest.approx(2560 / 23)


def _fake(*shape):
    return SimpleNamespace(shape=shape)


@pytest.mark.parametrize("wrapper,args,ms", [
    ("madd_scan", (_fake(16, 82048, 4, 21), 32), 0.23453),
    ("add", (_fake(16, 2564, 4, 21), _fake(16, 2564, 4, 21)), 0.01234),
    ("add_scan", (_fake(32, 1312, 4, 21), 32), 0.00855),
    ("add_total", (_fake(32, 8192, 4, 21), 32), 0.02711),
    ("double_chain", (_fake(608, 4, 21), 20, 13), 0.00713),
    ("sqr_chain", (None, _fake(608, 21), 100), 0.00032),
    ("double", (_fake(16, 4, 21),), 0.000003),
])
def test_roofline_counts_reproduce_the_kernel_table(wrapper, args, ms):
    got = roofline.least_seconds(*roofline.work(wrapper, args)) * 1e3
    assert got == pytest.approx(ms, rel=5e-3, abs=5e-7)


def test_roofline_counts_mul_rows_square_and_product():
    a, b = _fake(16, 2048, 21), _fake(16, 2048, 21)
    assert roofline.least_seconds(*roofline.work("mul_rows", (None, a, b))) * 1e3 == \
        pytest.approx(0.00246, rel=5e-3)
    assert roofline.least_seconds(*roofline.work("mul_rows", (None, a, a))) * 1e3 == \
        pytest.approx(0.00164, rel=5e-3)


def test_tampered_changes_t_x_by_one():
    proof = bytes(1 + 32 * 8) + (5).to_bytes(32, "little") + bytes(64)
    out = traffic.tampered(proof)
    assert int.from_bytes(out[257:289], "little") == 6
    assert out[:257] == proof[:257] and out[289:] == proof[289:]


def test_msm_matches_double_and_add():
    gen = np.random.default_rng(5)
    pts = [ED25519_BASEPOINT.scalar_mul(int(gen.integers(1, 2**40))) for _ in range(70)]
    scalars = [int.from_bytes(gen.bytes(32), "little") % L for _ in pts]
    want = ED25519_BASEPOINT.identity()
    for s, p in zip(scalars, pts):
        want = want + p.scalar_mul(s)
    got = msm.to_point(msm.msm(scalars, [msm.from_point(p) for p in pts]))
    assert got.ristretto_eq(want)


def test_blindbid_circuit_has_the_published_size():
    b = traffic.bidders(9, "x", 1, 4)[0]
    cs = circuits.blindbid(b["pub_list"], b["q"], b["z_img"], b["seed"])
    assert (cs.n_gates, cs.n_pad, cs.m) == (1454, 2048, 8)


# made once by the JAX package on the CPU: `prove_batch([request],
# rng=default_rng(42))`, commitments then toggle commitments then the proof
FROZEN = Path(__file__).parent / "data" / "blindbid_L4_seed42.hex"


def _frozen():
    blob = bytes.fromhex(FROZEN.read_text().strip())
    bid = circuits.bidder(123456789, 987654321, 55555, [1000, 1001, 1002], 2)
    rng = np.random.default_rng(42)
    gammas = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(8)]
    cs = circuits.blindbid(bid["pub_list"], bid["q"], bid["z_img"], bid["seed"], witness=bid)
    return cs, gammas, [blob[32 * i:32 * i + 32] for i in range(8)], blob[256:]


def test_the_reference_prover_makes_the_frozen_proof_again():
    cs, gammas, comms, proof = _frozen()
    differ, product = prove.check(cs, gammas, bytes(32), proof, comms, 2048,
                                  np.random.default_rng(1))
    assert differ == []
    assert verify.identity_many([lambda: product], 2048, np.random.default_rng(2))


@pytest.mark.parametrize("change", ["blinding", "seed", "witness", "t_x_blinding", "point"])
def test_the_reference_prover_tells_another_proof_apart(change):
    cs, gammas, comms, proof = _frozen()
    seed = bytes(32)
    if change == "blinding":
        gammas[5] += 1
    elif change == "seed":
        seed = b"\x01" * 32
    elif change == "witness":
        bid = circuits.bidder(123456789, 987654321, 55555, [1000, 1001, 1002], 2)
        bid = dict(bid, k=bid["k"] + 1)
        cs = circuits.blindbid(bid["pub_list"], bid["q"], bid["z_img"], bid["seed"],
                               witness=bid)
    elif change == "t_x_blinding":
        off = 1 + 32 * 9
        value = (int.from_bytes(proof[off:off + 32], "little") + 1) % L
        proof = proof[:off] + value.to_bytes(32, "little") + proof[off + 32:]
    else:  # T_1 replaced by T_3
        proof = proof[:97] + proof[129:161] + proof[129:]
    differ, product = prove.check(cs, gammas, seed, proof, comms, 2048,
                                  np.random.default_rng(1))
    assert differ or not verify.identity_many([lambda: product], 2048,
                                              np.random.default_rng(2))
