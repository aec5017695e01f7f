"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA card

Phases, in order; any failure exits non-zero:
  1. card and build: the nvidia-smi name/power-limit line, then nvcc builds
     the kernels from dusk_blindbidproof_tpu_torch/csrc and ptxas's
     register and spill lines are printed;
  2. kernels against their plain versions at the main path's shapes (K1 on
     16 x 2048 rows for both moduli; K2/K3/K4 on one bucket-scan step of
     16 x 2564 points; the 32-step scans madd_scan on 16 x 82040 and
     16 x 2 x 40980 Niels items, add_scan on 32 x 1281 and add_total on
     32 x 8191 points), random, all-8192 and identity inputs, compared
     exactly with canon(plain); kernel and plain times from CUDA events;
  3. the main path at B = 1: BlindBid prove at list length 4 with
     rng = default_rng(42) must give the frozen n = 2048 proof bytes,
     verify must accept it and reject a wrong seed, and the CAP = 8 cube
     proof must give its frozen bytes;
  4. the main path at B = 16: one warm-up round trip, TIMED_TRIPS timed
     round trips (median and spread of s/op), then one round trip with the
     spans on and the launch counts set to 0 just before it and read just
     after; every kernel of the path must have launched (all but the
     one-step madd, whose callers now go through madd_scan);
  5. the kernels line (JSON), the card line, then the result line.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FROZEN_BLINDBID = ROOT / "tests" / "data" / "blindbid_L4_seed42.hex"

# CAP = 8 cube proof (a^3 = public, a = 12345, blinding 111), frozen from the
# JAX package's host oracle
CUBE_V = "3ae11e63deaa22c68a3f5bd1888ac75c333b7f91cf5040eacf074d7c688e493a"
CUBE_PROOF = (
    "00105584d069fdf0452f22145994a613a7debbeb520f640e8546eef788133d176d"
    "e4f52da34e444189bef60a3f211c0c7824a1ad6c6f39f675d01ee5d23ba51026c4"
    "5c1ddc6e8576df37310a51113c31990c2e6436892794164ea9996da9f4c15d7c35"
    "1ef8c3565aa58cba9d3ebe93c054c03ead311d220ba802c50f8e8eadf23ec061cf"
    "d1063193785badd6c977576296f76f684869732bc31dc712910bf4b81960cdb6d5"
    "143203e045218ff92457c7afdd6906de29495fb7c8939f1fa6ed8d4e465f55789c"
    "7ccc72ef1becfa0800540faf50b8170d6303fb230caa38666abf0702461b9d1234"
    "4b66c08561db870d3f8c458c7776008d87afbba132c90e13740caeb7279c542029"
    "c2db9c39b4c6e922f05ed055b1af7880cf18b4f4d2e0b49e013e90705ea69a39be"
    "9f996de1faf16d411af82a67109eaa3e15e27a47bff1c801235eb9f19615efb340"
    "ea6a85d89962230ab2d757f289b8bdb945efa09a98a307a2b2df3de1e33061a77b"
    "603fc17ef6655f2c14d22eb8e51bb72b23c859e251072a5081fd331b7931b5bdc9"
    "6165f6a60b1b9379c498822095439c55f0b22c5e27ff864e175dfd60eb0934f4a8"
    "4a7a9fd3fe1848d504cfc1a55047797c5dc6d20727ffcfef228993c090940fce3f"
    "7d98d42fb9ff24adb4e3e797b75b9e140dd302"
)

# peaks of one H100 SXM at 700 W: HBM bytes/s from the data sheet, and the
# int32 multiply-add rate, half the 67 T/s float32 rate (64 IMAD lanes per
# SM and clock against 128 FFMA), a multiply-add counted as two operations
PEAK_BYTES = 3.35e12
PEAK_INT32_OPS = 33.5e12
# a field product as the work itself: a 256 x 256 bit product is 8 x 8 wide
# (32 x 32 -> 64) multiply-adds and 8 more fold it at 2^255 = 19; a wide
# multiply-add counts as four int32 operations.  Every kernel is held to
# this count, whatever arithmetic it runs today: a bound follows the
# function, not the implementation.
OPS_PER_FIELD_MUL = 4 * (8 * 8 + 8)
FIELD_MULS = {"madd": 7, "add": 9, "double": 8}
# bytes per point op, as the tensors' layout has them: madd reads 3 of q's 4
# Niels rows, double reads only X, Y and Z; every op writes one 4-row point
FE_BYTES = 4 * 21
POINT_BYTES = {"madd": (4 + 3 + 4) * FE_BYTES, "add": (4 + 4 + 4) * FE_BYTES,
               "double": (3 + 4) * FE_BYTES}
BLOCK_R = 32  # steps of one scan launch (ops/msm.py _BLOCK_R)
# bytes per scanned item: the item read once, its prefix written once; the
# totals-only scan writes one point per R items
SCAN_BYTES = {"madd_scan": (3 + 4) * FE_BYTES, "add_scan": (4 + 4) * FE_BYTES,
              "add_total": 4 * FE_BYTES + 4 * FE_BYTES / BLOCK_R}
SCAN_FIELD_MULS = {"madd_scan": 7, "add_scan": 9, "add_total": 9}
SOURCE = "dusk_blindbidproof_tpu_torch/csrc/edwards_kernels.cu"
PLANES = "dusk_blindbidproof_tpu/ops/fused.py:220"
REPLACES = {
    "mul_rows_fp": "dusk_blindbidproof_tpu/ops/fused.py:328",
    "mul_rows_fl": "dusk_blindbidproof_tpu/ops/fused.py:328",
    "madd": PLANES,
    "add": PLANES,
    "double": PLANES,
    "madd_scan": f"{PLANES} as driven by dusk_blindbidproof_tpu/ops/msm.py:357",
    "add_scan": f"{PLANES} as driven by dusk_blindbidproof_tpu/ops/msm.py:109",
    "add_total": f"{PLANES} as driven by dusk_blindbidproof_tpu/ops/msm.py:164",
}
# the scans' shapes on the main path at B = 16:
# (kernel, caller, leading shape x items, affine-Niels items, timed launches)
SCAN_CASES = [
    ("madd_scan", "phase A", (16, 82040), True, 5),
    ("madd_scan", "IPA round", (16, 2, 40980), True, 5),
    ("add_scan", "block totals", (32, 1281), False, 20),
    ("add_total", "bucket suffix sums", (32, 8191), False, 20),
]
OFF_PATH = ("madd",)  # checked in phase 2, no caller left on the main path
SCAN_WIDTH = 2564  # bucket-scan step width: 82040 items / 32 steps
ROWS = (16, 2048)  # K1: 16 proofs x n = 2048
TIMED_TRIPS = 5  # B = 16 round trips timed for the s/op median and spread


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_INT32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_ptxas(log: str) -> None:
    """The K2 / K3 / scan kernels must compile without spills into at most
    128 registers a thread (four blocks of 128 threads an SM): ptxas reports
    both per entry function."""
    lines = log.splitlines()
    seen = 0
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '\w*?(point_(?:step|scan)_kernelILi\d(?:ELi\d)?)", line)
        if not m:
            continue
        name = re.sub(r"ILi(\d)(?:ELi(\d))?", lambda t: "<" + ", ".join(filter(None, t.groups())) + ">",
                      m.group(1))
        props = " ".join(lines[i + 1:i + 4])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", props)
        regs = re.search(r"Used (\d+) registers", props)
        if not spill or not regs:
            fail(f"no ptxas report found for {name}")
        print(f"ptxas {name}: {regs.group(1)} registers, spill "
              f"{spill.group(1)} / {spill.group(2)} bytes", flush=True)
        if int(spill.group(1)) or int(spill.group(2)) or int(regs.group(1)) > 128:
            fail(f"{name} spills or holds more than 128 registers")
        seen += 1
    if seen != 5:
        fail(f"expected ptxas reports of 5 point kernels (2 one-step, 3 scans), found {seen}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(dev) -> dict:
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb

    gen = np.random.default_rng(2024)
    results = {}

    def rand(shape):
        return torch.from_numpy(gen.integers(0, 8193, size=shape, dtype=np.int32)).to(dev)

    # K1: random rows, all-8192 rows, zero rows
    for ctx in (limb.FP, limb.FL):
        name = f"mul_rows_{ctx.name}"
        a, b = rand((*ROWS, limb.NLIMBS)), rand((*ROWS, limb.NLIMBS))
        a[0, 0], b[0, 0] = 8192, 8192
        a[0, 1], b[0, 2] = 0, 0
        got = fused.mul_rows(ctx, a, b)
        want = limb.canon(ctx, fused.mul_rows_ref(ctx, a, b))
        err = int((got - want).abs().max())
        if err:
            fail(f"{name} disagrees with its plain version (max abs err {err})")
        ms = cuda_ms(lambda: fused.mul_rows(ctx, a, b), 50)
        plain = cuda_ms(lambda: fused.mul_rows_ref(ctx, a, b), 3)
        rows = ROWS[0] * ROWS[1]
        bms, by = bound_ms(rows * 3 * FE_BYTES, rows * OPS_PER_FIELD_MUL)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
        print(f"K1 {name}: max abs err 0 (tolerance 0) on {rows} rows, "
              f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms ({by})", flush=True)

    # K2-K4: one scan step of the bucket MSM; identity and all-8192 rows included
    shape = (16, SCAN_WIDTH, 4, limb.NLIMBS)
    p, q = rand(shape), rand(shape)
    p[0, 0] = 8192
    p[0, 1] = edwards.identity(device=dev)
    q[0, 2] = edwards.identity(device=dev)
    q_niels = q.clone()
    q_niels[0, 2] = edwards.identity_niels(device=dev)
    cases = {
        "madd": (fused.madd, fused.madd_ref, (p, q_niels)),
        "add": (fused.add, fused.add_ref, (p, q)),
        "double": (fused.double, fused.double_ref, (p,)),
    }
    n = shape[0] * shape[1]
    for name, (kern, ref, args) in cases.items():
        got = kern(*args)
        want = limb.canon(limb.FP, ref(*args))
        err = int((got - want).abs().max())
        if err:
            fail(f"{name} disagrees with its plain version (max abs err {err})")
        ms = cuda_ms(lambda: kern(*args), 20)
        plain = cuda_ms(lambda: ref(*args), 3)
        bms, by = bound_ms(n * POINT_BYTES[name], n * FIELD_MULS[name] * OPS_PER_FIELD_MUL)
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by)
        print(f"K {name}: max abs err 0 (tolerance 0) on {n} points, "
              f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms ({by})", flush=True)
    check_scans(dev, rand, results)
    return results


def check_scans(dev, rand, results) -> None:
    """The 32-step scan kernels at the main path's shapes, padded to whole
    blocks with identity items exactly as ops/msm.py pads them."""
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb, msm

    def items(shape, niels):
        x = rand((*shape, 4, limb.NLIMBS))
        ident = (edwards.identity_niels if niels else edwards.identity)(device=dev)
        flat = x.view(-1, x.shape[-3], 4, limb.NLIMBS)
        flat[0, 0] = 8192  # the largest rows the plain engine hands over
        flat[0, 1] = ident
        flat[-1, 33:40] = ident  # a run of identities inside one block
        return msm._blocked(x, niels=niels)[0]

    for name, label, shape, niels, reps in SCAN_CASES:
        x = items(shape, niels)
        kern, ref = getattr(fused, name), getattr(fused, name + "_ref")
        got, want = kern(x, BLOCK_R), ref(x, BLOCK_R)
        if name == "add_total":
            got, want = (got,), (want,)
        err = 0
        for g, w in zip(got, want):
            if g.shape != w.shape:
                fail(f"{name} ({label}): shape {tuple(g.shape)} != {tuple(w.shape)}")
            err = max(err, int((g - limb.canon(limb.FP, w)).abs().max()))
        if err:
            fail(f"{name} ({label}) disagrees with its plain version (max abs err {err})")
        del got, want, g, w
        ms = cuda_ms(lambda: kern(x, BLOCK_R), reps)
        plain = cuda_ms(lambda: ref(x, BLOCK_R), 1)
        n = x.numel() // (4 * limb.NLIMBS)
        bms, by = bound_ms(n * SCAN_BYTES[name], n * SCAN_FIELD_MULS[name] * OPS_PER_FIELD_MUL)
        print(f"K {name} ({label}): max abs err 0 (tolerance 0) on {n} items in "
              f"{n // BLOCK_R} blocks of {BLOCK_R}, kernel {ms:.4f} ms, plain {plain:.3f} ms, "
              f"bound {bms:.4f} ms ({by})", flush=True)
        # the kernels line carries each scan at its first (largest) shape
        results.setdefault(name, dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                      bound_ms=bms, bound_by=by))


# ---------------------------------------------------------------------------
# Phases 3-4: the main path
# ---------------------------------------------------------------------------


def requests(n: int):
    from dusk_blindbidproof_tpu_torch.models.blindbid import make_prove_request

    return [
        make_prove_request(
            d=123456789 + 7919 * i, k=987654321 + 104729 * i, seed=55555 + i,
            pub_list_extra=[1000 + 3 * i + j for j in range(3)], toggle_pos=(2 + i) % 4,
        )
        for i in range(n)
    ]


def verify_requests(reqs, proofs, seed_bump=0):
    from dusk_blindbidproof_tpu_torch.models.blindbid import VerifyRequest

    return [
        VerifyRequest(proof=p, score=r.q, z_img=r.z_img, seed=r.seed + seed_bump,
                      pub_list=r.pub_list)
        for r, p in zip(reqs, proofs)
    ]


def main_path_b1(dev) -> None:
    from dusk_blindbidproof_tpu_torch.models.blindbid import (
        proof_blob, prove_batch, verify_batch,
    )

    reqs = requests(1)
    t0 = time.perf_counter()
    proofs = prove_batch(reqs, rng=np.random.default_rng(42), device=dev)
    t1 = time.perf_counter()
    frozen = FROZEN_BLINDBID.read_text().strip()
    if proof_blob(proofs[0]).hex() != frozen:
        fail("B=1 BlindBid proof differs from the frozen n = 2048 vector")
    ok = verify_batch(verify_requests(reqs, proofs), device=dev)
    bad = verify_batch(verify_requests(reqs, proofs, seed_bump=1), device=dev)
    t2 = time.perf_counter()
    if ok != [True] or bad != [False]:
        fail(f"B=1 verify gave {ok} for the proof and {bad} for a wrong seed")
    print(f"B=1: proof bytes equal the frozen vector; verify [True], wrong seed [False] "
          f"(first prove {t1 - t0:.3f} s incl. tables, verify x2 {t2 - t1:.3f} s)", flush=True)
    cube_proof(dev)


def cube_proof(dev) -> None:
    from dusk_blindbidproof_tpu_torch.models.bulletproofs import (
        CompiledCircuit, Prover, ProverWitness,
    )
    from dusk_blindbidproof_tpu_torch.models.r1cs import LC, VerifierCS
    from dusk_blindbidproof_tpu_torch.ops import limb
    from dusk_blindbidproof_tpu_torch.utils.curve_host import L
    from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript

    cs = VerifierCS()
    a = cs.commit_var()
    pub = cs.public_var()
    _, _, o = cs.multiply(LC.of(a), LC.of(a))
    _, _, o2 = cs.multiply(LC.of(o), LC.of(a))
    cs.constrain(LC.of(o2) - pub)
    circuit = CompiledCircuit.compile(cs.artifact(), dev)
    A, blind = 12345, 111
    a2, a3 = A * A % L, A * A * A % L
    prover = Prover([Transcript(b"tiny-cube-proof")], cap=8, device=dev)
    commitments = prover.commit_batch([[A]], [[blind]])
    fast = limb.ints_to_limbs_fast
    witness = ProverWitness(
        a_L=fast([A, a2], (1, 2)), a_R=fast([A, A], (1, 2)), a_O=fast([a2, a3], (1, 2)),
        v=fast([A], (1, 1)), v_blinding=fast([blind], (1, 1)), publics=fast([a3], (1, 1)),
    )
    proof = prover.prove(circuit, witness)[0]
    if commitments[0][0].hex() != CUBE_V or proof.to_bytes().hex() != CUBE_PROOF:
        fail("CAP = 8 cube proof differs from its frozen bytes")
    print("CAP=8 cube proof: equal to the frozen bytes", flush=True)


def main_path_b16(dev) -> tuple[dict, list[float]]:
    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch, verify_batch
    from dusk_blindbidproof_tpu_torch.ops import fused
    from dusk_blindbidproof_tpu_torch.utils import profiling

    B = 16
    reqs = requests(B)

    def round_trip():
        proofs = prove_batch(reqs, rng=np.random.default_rng(7), device=dev)
        oks = verify_batch(verify_requests(reqs, proofs), device=dev)
        torch.cuda.synchronize()
        return oks

    t0 = time.perf_counter()
    if round_trip() != [True] * B:
        fail("B=16 warm-up round trip did not verify")
    warm = time.perf_counter() - t0
    s_per_op = []
    for _ in range(TIMED_TRIPS):
        t0 = time.perf_counter()
        oks = round_trip()
        s_per_op.append((time.perf_counter() - t0) / B)
        if oks != [True] * B:
            fail("B=16 timed round trip did not verify")
    print(f"B=16 s/op over {TIMED_TRIPS} round trips: median {np.median(s_per_op)}, "
          f"min {min(s_per_op)}, max {max(s_per_op)}, all {s_per_op} "
          f"(warm-up {warm:.3f} s)", flush=True)
    profiling.enable()
    profiling.reset()
    fused.reset_launch_counts()
    oks = round_trip()
    counts = fused.launch_counts()
    profiling.enable(False)
    if oks != [True] * B:
        fail("B=16 profiled round trip did not verify")
    print(profiling.report(), flush=True)
    print(f"launches in that round trip: {counts}", flush=True)
    missing = [k for k, v in counts.items() if v == 0 and k not in OFF_PATH]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    return counts, s_per_op


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    try:
        from dusk_blindbidproof_tpu_torch.ops import fused
    except ImportError as exc:
        fail(f"the port's package is not importable here ({exc})")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    t0 = time.perf_counter()
    fused.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {fused.BUILD_SECONDS} s)", flush=True)
    print(fused.BUILD_LOG.strip(), flush=True)
    check_ptxas(fused.BUILD_LOG)

    kernels = check_kernels(dev)
    main_path_b1(dev)
    counts, s_per_op = main_path_b16(dev)

    line = []
    for name, r in kernels.items():
        line.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": counts[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None,
        })
    print(f"s/op at B=16: median {np.median(s_per_op)} over {TIMED_TRIPS} round trips")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1,  # the run uses cuda:0 only
    }}))


if __name__ == "__main__":
    main()
