"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py    # needs one CUDA card

Phases, in order; any failure exits non-zero:
  1. card and build: the nvidia-smi name/power-limit line, then nvcc builds
     the kernels from dusk_blindbidproof_tpu_torch/csrc and ptxas's
     register and spill lines are printed and checked for every kernel;
  2. kernels against their plain versions at the main path's shapes: K1 mod p
     on 16 x 38 rows first (its shape on the main path: the verifier's 38
     dynamic points a proof), then both moduli on 16 x 2048 rows and with an
     operand that is not 16-byte aligned; the squaring chain on 608 rows for
     k = 2, 50, 100; K3 on one bucket-scan step of 16 x 2564 points; K4 on
     16 points (the Horner step), 16 x 38 and 16 x 2564; the doubling chain
     on 608 and 4098 points x 20 windows x 13 steps; the 32-step scans
     madd_scan on 16 x 82040 and 16 x 2 x 40980 Niels items, add_scan on
     32 x 1281 and add_total on 32 x 8191 points, and madd_scan with R = 2 on
     16 x 2564 blocks; random, all-8192, zero and identity inputs, compared
     exactly with canon(plain); Ristretto compression on the B = 16 prover's
     16 x 8 commitments and 16 x 2 IPA points (curve points made by K3, an
     identity and an all-8192 row), byte for byte against its plain version
     on the CPU, with the host's per-point compression timed beside it;
     kernel time from CUDA events around a replayed
     CUDA graph of wrapper calls, eager-loop and plain times from CUDA events;
     b. the BlindBid witness (`witness_wires`: mimc_chain, then
        witness_fanout) at WITNESS_CASES, 4 bids at B = 256, 1 and 16, 202
        bids at B = 16, and a rank's 64 rows of B = 256: each launch
        synchronised, two launches a call, the wires exact against the plain
        version on the CPU; each kernel timed apart.  Phases 4 and 9 hold
        every prove_batch to one launch of each and no plain call;
  3. the main path at B = 1: BlindBid prove at list length 4 with
     rng = default_rng(42) must give the frozen n = 2048 proof bytes,
     verify must accept it and reject a wrong seed, and the CAP = 8 cube
     proof must give its frozen bytes;
  4. the main path at B = 16: one warm-up round trip, TIMED_TRIPS timed
     round trips (median and spread of s/op), then one round trip with the
     spans on and the launch counts set to 0 just before it and read just
     after; every kernel must have launched, and the two chains must have
     kept the one-step launches of K4 and K1 mod p below LAUNCH_LIMITS;
  5. the server, driven with wire bytes over a real Unix socket (the client
     functions of scripts/uds_client_torch.py):
     a. in this process, `BlindBidServer` on an event loop in a thread, the
        launch counts set to 0 just before it starts: the recorded verify
        session (a proof the JAX package made) must give the recorded
        response bytes; the recorded prove request a proof that verifies, and
        0x00 with a changed seed; a bad opcode and a prove body cut short give
        0xff and the daemon answers on; seven hostile requests (HOSTILE: verify
        and prove with 203 bids, over the generator capacity; verify with 0
        bids, with 10 IPA rounds at 4 bids, with an odd A_I1; prove and verify
        with 20,000 bids, refused from the list's length before any synthesis)
        each answer exactly 0xff, launch no kernel and leave no fault, each
        answer's time printed beside the card; then, on the same
        server, 16, 5, 11 and 17 connections at once, each proving and then
        verifying its own proof, with the batch sizes the service flushed and
        the wall time an operation printed.
        Before it, without the socket, the recorded prove request with
        rng = default_rng(2026) must give the recorded proof bytes.  Every
        kernel must have launched; an error frame for a well-formed request,
        a device fault or an exception in the server's thread fails the run;
     b. the entry point, `python -m dusk_blindbidproof_tpu_torch.server` with
        no --device, as a subprocess: time to listening, one prove + verify,
        the 203-bid verify and the 20,000-bid prove request (each 0xff, its
        time printed), 16 at once, alive before it is terminated;
     c. the scripts, as subprocesses started together, each of which must exit
        0: scripts/test-uds-torch.sh (server + client over a socket),
        scripts/oracle_compare_torch.py 8 and scripts/record_session_torch.py
        (the frozen session bytes, written under build/);
  6. the mesh on the one card: parallel.mesh.spawn starts 4 ranks on cuda:0
     over gloo, the launch counts set to 0 in every rank just before its mesh
     path and read just after: prove_batch / verify_batch at B = 16 with
     rng = default_rng(7) at bids x points = 4 x 1 and 2 x 2 (every proof's
     digest equal to phase 4's, all verify, a wrong seed rejected in its own
     place, MESH_TRIPS timed round trips each), B = 5 and 3 at 4 x 1 (uneven
     rows, then a rank with none), BASELINE config 4's CONFIG4_BATCH = 256
     requests at 4 x 1 (64 bids a rank: all verify, one timed round trip, the
     256 digests handed to phase 9), sharded_msm over the 4096 G and H
     generators at 1 x 4 and over 64 points against host sums,
     sharded_bucket_step at 2 x 2, dryrun_multichip; every kernel must have
     launched in the ranks (counts summed over ranks).  A rank's exception,
     non-zero exit or timeout fails the run;
  7. the generic R1CS path on the chain circuit of benchmarks/ipa_bench.py:47-69
     (one committed input v0 = 3, n_pad - 1 gates w_{i+1} = w_i * w_i), built
     with the port's models/r1cs.py (`chain_inputs`) and driven through
     CompiledCircuit.compile, Prover(cap = n_pad).commit_batch / prove and
     Verifier(cap = n_pad).commit_batch / verify:
     a. n = cap = 2^10, B = 1: the proof bytes must equal the frozen vector
        tests/data/ipa_chain_n1024.hex (made by the JAX package's host
        oracle), verify must accept it and reject it with t_x + 1;
     b. n = cap = 2^16 at B = CHAIN_BATCH: the 131074-generator tables (host
        derivation and device build timed apart), one warm-up round trip,
        CHAIN_TRIPS timed round trips (s/op median and spread), every proof
        verifies and one with ipp_a + 1 is rejected in its own place, one round
        trip with the spans on and the launch counts set to 0 just before it and
        read just after (every kernel must have launched), the peak device
        memory, and the device-busy share of one round trip under
        torch.profiler (kernel events, as scripts/profile_port.py reckons it);
     c. the kernels at 7b's shapes: madd_scan on phase A's and an IPA round's
        items, double_chain on the 131074 table points, K1 mod l on B x 2^16
        rows, compress on an IPA round's B x 2 points, exact against
        canon(plain) (the scans and the chain on slices of rows, LARGE_SLICE),
        timed as in phase 2;
  8. the full list: BlindBid at FULL_LIST = 202 bids, the longest list the
     generators hold (n1 = 1442 + 3 x 202 = n = 2048, 206 commitments, 205
     publics; the verifier's dynamic MSM has 236 points a proof, 4720 window
     items, so it takes the bucket path where list length 4 takes the bit
     path):
     a. B = 1: prove with rng = default_rng(42) must give the frozen vector
        tests/data/blindbid_L202_seed42.hex (made by the JAX package), verify
        must accept it and reject a wrong seed;
     b. B = 16: one warm-up round trip, TIMED_TRIPS timed round trips (s/op
        median and spread, beside phase 4's), every proof verifies and a wrong
        seed is rejected in its own place only; one round trip with the spans
        on and the launch counts set to 0 just before it and read just after,
        in which the verifier's dynamic MSM must have launched add_scan (its
        leaf) and the one-step launches of K4 and K1 mod p must not exceed
        phase 4's; the device-busy share of one round trip under torch.profiler;
     c. the kernels at 8b's shapes, exact against canon(plain) and timed as in
        phase 2: add_scan on the verifier's own leaf items (decompressed,
        window-scaled, sorted proof points, identity-padded to whole blocks),
        then with all-8192 and identity rows put in; double_chain, sqr_chain
        (k = 2, 50, 100) and K1 mod p on the B x 236 rows of the verifier;
     d. the server in this process (as in 5a), the circuit cache emptied
        first so that the first 202-bid request builds its circuit inside the
        request (its latency printed apart): 16 connections at once at 202
        bids, then 8 at 4 bids and 8 at 202 bids at once, each proving and
        then verifying its own proof; every batch flushed holds one list
        length, and both lengths are flushed apart.
     Phase 8 takes about 70 s of the run's 370 s on an NVIDIA H100 80GB HBM3;
  9. BASELINE.md config 4, 256 independent bids: requests(CONFIG4_BATCH)
     (list length 4, n1 = 1454, n = 2048) through prove_batch / verify_batch
     in one batch with rng = default_rng(7):
     a. one warm-up round trip: every proof verifies, its digest equals the
        one phase 6's 4 x 1 ranks made (rank 0's draws are broadcast, so the
        bytes agree) and the first 16 equal phase 4's; a wrong seed at place
        CONFIG4_BAD is rejected there only; CONFIG4_TRIPS timed round trips
        (s/op median and spread beside phase 4's); one round trip with the
        spans on and the launch counts set to 0 just before it and read just
        after (every kernel must have launched), in which `KernelShapes`
        keeps each kernel's largest call; the peak device memory of the
        phase; the device-busy share of one round trip under torch.profiler;
     b. every kernel at the largest shape 9a gave it (compress: the 256 x 8
        commitments), exact against canon(plain) on LARGE_SLICE units at each
        end, timed as in phase 2;
 10. the kernels line (JSON), the card line, then the result line.
"""

from __future__ import annotations

import asyncio
import hashlib
import importlib.util
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FROZEN_BLINDBID = ROOT / "tests" / "data" / "blindbid_L4_seed42.hex"
# one prove and one verify round trip as wire bytes, recorded from the JAX
# package: TLV(request) ++ TLV(response); the prove one with rng = default_rng(2026)
SESSION_PROVE = ROOT / "tests" / "data" / "session_prove.bin"
SESSION_VERIFY = ROOT / "tests" / "data" / "session_verify.bin"
RECORDED_RNG_SEED = 2026

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
# a square needs each cross product once: 8 * 9 / 2 wide multiplies and the fold
OPS_PER_FIELD_SQR = 4 * (8 * 9 // 2 + 8)
# a point op as the work itself: an addition is 9 products; a doubling is 4
# squares and 3 products, and 1 product more where T of the result is needed
OPS_PER_ADD = 9 * OPS_PER_FIELD_MUL
OPS_PER_DOUBLE_XYZ = 4 * OPS_PER_FIELD_SQR + 3 * OPS_PER_FIELD_MUL
OPS_PER_DOUBLE = OPS_PER_DOUBLE_XYZ + OPS_PER_FIELD_MUL
# bytes per point op, as the tensors' layout has them: double reads only X, Y
# and Z; every op writes one 4-row point
FE_BYTES = 4 * 21
POINT_BYTES = {"add": (4 + 4 + 4) * FE_BYTES, "double": (3 + 4) * FE_BYTES}
BLOCK_R = 32  # steps of one scan launch (ops/msm.py _BLOCK_R)
# rows a scanned item brings (madd reads three Niels rows) and field products a step
SCAN_ITEM_ROWS = {"madd_scan": 3, "add_scan": 4, "add_total": 4}
SCAN_FIELD_MULS = {"madd_scan": 7, "add_scan": 9, "add_total": 9}
SOURCE = "dusk_blindbidproof_tpu_torch/csrc/edwards_kernels.cu"
PLANES = "dusk_blindbidproof_tpu/ops/fused.py:220"
SCALAR_MUL = "dusk_blindbidproof_tpu/ops/fused.py:328"
HOST_COMPRESS = "dusk_blindbidproof_tpu/models/bulletproofs.py:119"
HOST_WITNESS = "dusk_blindbidproof_tpu/models/blindbid.py blindbid_witness"
REPLACES = {
    "mul_rows_fp": SCALAR_MUL,
    "mul_rows_fl": SCALAR_MUL,
    "sqr_chain": f"{SCALAR_MUL} as driven by dusk_blindbidproof_tpu/ops/ristretto.py:33",
    "add": PLANES,
    "double": PLANES,
    "double_chain": f"{PLANES} as driven by dusk_blindbidproof_tpu/ops/msm.py:67",
    "madd_scan": f"{PLANES} as driven by dusk_blindbidproof_tpu/ops/msm.py:357",
    "add_scan": f"{PLANES} as driven by dusk_blindbidproof_tpu/ops/msm.py:109",
    "add_total": f"{PLANES} as driven by dusk_blindbidproof_tpu/ops/msm.py:164",
    "compress": f"no TPU kernel: the host's per-point compression, {HOST_COMPRESS}",
    "mimc_chain": f"no TPU kernel: the host's witness, {HOST_WITNESS}",
    "witness_fanout": f"no TPU kernel: the host's witness, {HOST_WITNESS}",
}
# products of the witness's four hashes a proof: 90 rounds of four
WITNESS_HASH_MULS = 4 * 90 * 4
# Ristretto compression a point (ristretto_compress_kernel): squares and
# products of its field chain, and the point read plus the encoding written
COMPRESS_SQRS, COMPRESS_MULS = 258, 34
COMPRESS_BYTES = 4 * FE_BYTES + 32
COMPRESS_OPS = COMPRESS_SQRS * OPS_PER_FIELD_SQR + COMPRESS_MULS * OPS_PER_FIELD_MUL
# the scans' shapes on the main path at B = 16:
# (kernel, caller, leading shape x items, affine-Niels items, R, timed launches)
SCAN_CASES = [
    ("madd_scan", "phase A", (16, 82040), True, BLOCK_R, 5),
    ("madd_scan", "IPA round", (16, 2, 40980), True, BLOCK_R, 5),
    ("add_scan", "block totals", (32, 1281), False, BLOCK_R, 20),
    ("add_total", "bucket suffix sums", (32, 8191), False, BLOCK_R, 20),
    # K2's formula on a running sum that is not the identity, one step wide
    ("madd_scan", "two-step blocks", (16, 2 * 2564), True, 2, 20),
]
SCAN_WIDTH = 2564  # bucket-scan step width: 82040 items / 32 steps
ROWS = (16, 2048)  # K1: 16 proofs x n = 2048
# dynamic points of one proof in the verifier at list length 4: the 4 + 4
# commitments, T_1,3,4,5,6, A_I1 A_O1 S1 and 11 rounds of L_j R_j (phase 2's
# are the identity and left out); 16 proofs' are decompressed, then window-scaled
VERIFY_POINTS_A_PROOF = (4 + 4) + 5 + 3 + 2 * 11
VERIFY_POINTS = 16 * VERIFY_POINTS_A_PROOF
TABLE_POINTS = 2 * 2048 + 2  # generators of the window tables at capacity 2048
WINDOWS, WINDOW_STEPS = 20, 13  # ops/msm.py WINDOWS, LIMB_BITS
SQR_CHAIN_K = (100, 50, 2)  # runs of squarings in x^(2^252 - 3); the longest goes in the kernels line
# launches of a B = 16 round trip that the chains must have taken over: K4 is
# left with the 3 x 12 Horner steps, K1 mod p with the products between chains
LAUNCH_LIMITS = {"double": 40, "mul_rows_fp": 60}
N_KERNELS = 13  # entry functions: 3 mul_rows, sqr_chain, add, double, double_chain, 3 scans, compress,
# mimc_chain, witness_fanout
# the kernels of the BlindBid witness, which the chain circuit (phase 7) bypasses
WITNESS_KERNELS = ("mimc_chain", "witness_fanout")
# phase 2b: the witness at the shapes of its callers, (B, list length, the rows
# a rank proves or None); the first is the kernels line's
WITNESS_CASES = ((256, 4, None), (1, 4, None), (16, 4, None), (16, 202, None),
                 (256, 4, slice(64, 128)))
WITNESS_REPS = 20
TIMED_TRIPS = 5  # B = 16 round trips timed for the s/op median and spread
# phase 5: connections opened at once, in this order; 16 is the service's cap,
# 5 and 11 are batches that are not a power of two, 17 must split
CLIENTS_AT_ONCE = (16, 5, 11, 17)
MAX_BATCH = 16
# hostile requests: 203 bids make n1 = 1442 + 3 x 203 = 2051 gates, so n_pad =
# 4096 > GENS_CAPACITY = 2048 (a verify proof of it has 12 IPA rounds); 20,000
# bids make n_pad = 65536 (16 rounds), a circuit that takes minutes to
# synthesize on the host, so it must be refused from the list's length
OVER_CAPACITY_BIDS = 203
LONG_LIST_BIDS = 20000
HOSTILE = ("verify, 203 bids", "prove, 203 bids", "verify, 0 bids",
           "verify, 10 IPA rounds at 4 bids", "verify, odd A_I1",
           "prove, 20000 bids", "verify, 20000 bids")
PARSE_REPS = 100  # parses timed for the host's cost of one request
SERVER_START_TIMEOUT = 300  # s, for the socket of a starting server to appear
SCRIPT_TIMEOUT = 420  # s, for each script of phase 5c
# phase 6: ranks on cuda:0, the layouts of the B = 16 round trips, timed trips a
# layout, and the place whose seed is changed in each layout's wrong-seed pass
MESH_RANKS = 4
MESH_LAYOUTS = {(4, 1): 5, (2, 2): 12}
MESH_TRIPS = 3
MESH_UNEVEN_B = (5, 3)  # batches at 4 x 1 that do not divide: 2 + 1 + 1 + 1, and an empty rank
MESH_MSM_SEED = 11
MESH_TIMEOUT = 600  # s, for the whole phase 6 job
# phase 7: the chain circuit of benchmarks/ipa_bench.py:47-69, its transcript
# label, input and blinding; the prover's 32 seed bytes come from
# default_rng(CHAIN_SEED)
CHAIN_LABEL = b"ipa-bench"
CHAIN_V0, CHAIN_BLIND = 3, 7
CHAIN_SEED = 1024
FROZEN_CHAIN = ROOT / "tests" / "data" / "ipa_chain_n1024.hex"
CHAIN_SMALL = 1 << 10  # 7a: n = cap, B = 1, against the frozen bytes
CHAIN_LARGE = 1 << 16  # 7b: n = cap, BASELINE.md config 3's top size
# 7b's batch: the largest power of two up to the server's 16 that fits the
# card (scripts/chain_batch_torch.py measures the peak memory of each)
CHAIN_BATCH = 16
CHAIN_TRIPS = 3  # timed round trips of 7b
# 7c: plain versions run on this many blocks (scans) or points (the chain) at
# each end of the kernel's rows; K1 is compared whole
LARGE_SLICE = 2048
# phase 8: the longest bid list the generators hold, n1 = 1442 + 3 x 202 = 2048
FULL_LIST = 202
FROZEN_FULL_LIST = ROOT / "tests" / "data" / "blindbid_L202_seed42.hex"
# dynamic points of one proof in the verifier: the 4 + 202 commitments,
# T_1,3,4,5,6, A_I1 A_O1 S1 and 11 rounds of L_j R_j (phase 2's are the identity)
FULL_LIST_POINTS = (4 + FULL_LIST) + 5 + 3 + 2 * 11
FULL_LIST_BATCH = 16  # 8b's batch, the server's cap
FULL_LIST_BAD = 9  # the place whose seed is changed in 8b's wrong-seed pass
FULL_LIST_CLIENTS = 16  # 8d's connections at once: all at 202 bids, then half and half
# phase 9: BASELINE.md config 4, 256 independent bids (list length 4) in one
# batch; its timed round trips, the place whose seed is changed, and the
# layout of phase 6's ranks that proves the same batch (64 bids a rank)
CONFIG4_BATCH = 256
CONFIG4_TRIPS = 2
CONFIG4_BAD = 201
CONFIG4_MESH_LAYOUT = (4, 1)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Time of one call of `fn` in a loop of eager calls, by CUDA events: for a
    kernel that runs shorter than its wrapper takes to enqueue it (about
    20 us), this is the host's rate, not the kernel's time."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int) -> float:
    """Time of one call of `fn` on the device: `reps` calls of the wrapper are
    captured into one CUDA graph (the wrappers launch on the current stream,
    which is the capturing one), and the graph's replay is timed by CUDA
    events, so that no host time lies between two launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_INT32_OPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_ptxas(log: str) -> None:
    """Every kernel of the library must compile without spills into at most
    128 registers a thread (four blocks of 128 threads an SM): ptxas reports
    both per entry function."""
    lines = log.splitlines()
    seen = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if not m:
            continue
        name = m.group(1)  # mangled: the template arguments tell the instantiations apart
        props = " ".join(lines[i + 1:i + 4])
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", props)
        regs = re.search(r"Used (\d+) registers", props)
        if not spill or not regs:
            fail(f"no ptxas report found for {name}")
        print(f"ptxas {name}: {regs.group(1)} registers, spill "
              f"{spill.group(1)} / {spill.group(2)} bytes", flush=True)
        if int(spill.group(1)) or int(spill.group(2)) or int(regs.group(1)) > 128:
            fail(f"{name} spills or holds more than 128 registers")
        seen.append(name)
    if len(seen) != N_KERNELS or len(set(seen)) != N_KERNELS:
        fail(f"expected ptxas reports of {N_KERNELS} kernels, found {len(seen)}: {seen}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


class KernelChecks:
    """Runs one kernel case after another: exact against canon(plain), then
    timed (`ms` is the kernel's time on the device, from a replayed CUDA graph
    of wrapper calls; the eager loop's time a call is printed beside it);
    keeps each kernel's first case for the kernels line."""

    def __init__(self, dev):
        self.dev = dev
        self.gen = np.random.default_rng(2024)
        self.results = {}
        self.rows = []  # every case, in order

    def rand(self, shape):
        x = self.gen.integers(0, 8193, size=shape, dtype=np.int32)
        return torch.from_numpy(x).to(self.dev)

    def case(self, name, label, kern, ref, ctx, n_bytes, n_ops, reps, plain_reps=1):
        """kern and ref take no arguments and return a tensor or a tuple of
        tensors; ctx None (encodings, not limbs) compares them as they are.
        Returns the kernel's ms."""
        from dusk_blindbidproof_tpu_torch.ops import limb

        got, want = kern(), ref()
        if isinstance(got, torch.Tensor):
            got, want = (got,), (want,)
        err = 0
        for g, w in zip(got, want):
            if g.shape != w.shape:
                fail(f"{name} ({label}): shape {tuple(g.shape)} != {tuple(w.shape)}")
            err = max(err, int((g - canon_of(ctx, w)).abs().max()))
        if err:
            fail(f"{name} ({label}) disagrees with its plain version (max abs err {err})")
        del got, want, g, w
        ms = device_ms(kern, reps)
        eager = cuda_ms(kern, reps)
        plain = cuda_ms(ref, plain_reps)
        bms, by = bound_ms(n_bytes, n_ops)
        print(f"K {name} ({label}): max abs err 0 (tolerance 0), kernel {ms:.5f} ms "
              f"({eager:.4f} ms a call in an eager loop), plain {plain:.3f} ms, "
              f"bound {bms:.6f} ms ({by})", flush=True)
        row = dict(max_abs_err=err, ms=ms, eager_ms=eager, plain_ms=plain, bound_ms=bms,
                   bound_by=by)
        self.results.setdefault(name, row)
        self.rows.append(dict(name=name, label=label, **row))
        return ms


def canon_of(ctx, x: torch.Tensor) -> torch.Tensor:
    """canon(x) mod ctx's modulus; x itself where ctx is None (encodings)."""
    from dusk_blindbidproof_tpu_torch.ops import limb

    return x if ctx is None else limb.canon(ctx, x)


def check_kernels(dev) -> dict:
    checks = KernelChecks(dev)
    check_rows(checks)
    check_points(checks)
    check_scans(checks)
    check_compress(checks)
    check_witness(checks)
    return checks.results


def check_rows(checks) -> None:
    """K1 and the squaring chain: random rows, all-8192 rows, zero rows."""
    from dusk_blindbidproof_tpu_torch.ops import fused, limb

    nl = limb.NLIMBS

    def operands(shape):
        a, b = checks.rand((*shape, nl)), checks.rand((*shape, nl))
        a[0, 0], b[0, 0] = 8192, 8192
        a[0, 1], b[0, 2] = 0, 0
        return a, b

    def product(ctx, label, a, b):
        rows = a.numel() // nl
        ops = OPS_PER_FIELD_SQR if a is b else OPS_PER_FIELD_MUL
        checks.case(f"mul_rows_{ctx.name}", f"{label}, {rows} rows",
                    lambda: fused.mul_rows(ctx, a, b), lambda: fused.mul_rows_ref(ctx, a, b),
                    ctx, rows * (2 if a is b else 3) * FE_BYTES, rows * ops, 50, 3)

    # first the shape at which the main path launches K1 mod p: the products
    # of the verifier's decompression (the kernels line keeps a kernel's first case)
    a, b = operands((16, VERIFY_POINTS_A_PROOF))
    product(limb.FP, "decompression", a, b)
    for ctx in (limb.FP, limb.FL):
        a, b = operands(ROWS)
        product(ctx, "product", a, b)
        product(ctx, "square", a, a)
        # an operand that starts 84 bytes past a 16-byte boundary: right, not refused
        wide = checks.rand((ROWS[0] * ROWS[1] + 1, nl))
        wide[1] = 8192
        if wide[1:].data_ptr() % 16 == 0 or not wide[1:].is_contiguous():
            fail("the sliced operand was meant to be contiguous and off the 16-byte grid")
        product(ctx, "operand sliced from row 1", wide[1:], b.view(-1, nl))

    x = checks.rand((VERIFY_POINTS, nl))
    x[0], x[1] = 8192, 0
    x[2] = torch.from_numpy(limb.int_to_limbs(1)).to(checks.dev)
    for k in SQR_CHAIN_K:
        checks.case("sqr_chain", f"{VERIFY_POINTS} rows, k = {k}",
                    lambda: fused.sqr_chain(limb.FP, x, k),
                    lambda: fused.sqr_chain_ref(limb.FP, x, k), limb.FP,
                    VERIFY_POINTS * 2 * FE_BYTES, VERIFY_POINTS * k * OPS_PER_FIELD_SQR, 50)


def check_points(checks) -> None:
    """K3, K4 and the doubling chain; identity and all-8192 rows included."""
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb

    def points(n):
        p = checks.rand((n, 4, limb.NLIMBS))
        p[0] = 8192
        p[1] = edwards.identity(device=checks.dev)
        return p

    n = 16 * SCAN_WIDTH
    p, q = points(n), points(n)
    checks.case("add", f"{n} points", lambda: fused.add(p, q), lambda: fused.add_ref(p, q),
                limb.FP, n * POINT_BYTES["add"], n * OPS_PER_ADD, 20, 3)
    step_ms = {}
    for n, label in ((16, "Horner step"), (VERIFY_POINTS, "a step of the verifier's chain"),
                     (16 * SCAN_WIDTH, "a bucket-scan step's width")):
        p = points(n)
        step_ms[n] = checks.case(
            "double", f"{label}, {n} points", lambda: fused.double(p),
            lambda: fused.double_ref(p), limb.FP, n * POINT_BYTES["double"],
            n * OPS_PER_DOUBLE, 50, 3)
    doubles = (WINDOWS - 1) * WINDOW_STEPS
    for n, label in ((VERIFY_POINTS, "verifier"), (TABLE_POINTS, "generator tables")):
        p = points(n)
        ms = checks.case(
            "double_chain", f"{label}, {n} points x {WINDOWS} windows x {WINDOW_STEPS} steps",
            lambda: fused.double_chain(p, WINDOWS, WINDOW_STEPS),
            lambda: fused.double_chain_ref(p, WINDOWS, WINDOW_STEPS), limb.FP,
            n * (1 + WINDOWS) * 4 * FE_BYTES,
            # T is needed only of the WINDOWS - 1 doublings whose point is stored
            n * (doubles * OPS_PER_DOUBLE_XYZ + (WINDOWS - 1) * OPS_PER_FIELD_MUL), 10)
        if n in step_ms:
            print(f"  {doubles} one-step doubles at {n} points would take "
                  f"{doubles} x {step_ms[n]:.4f} = {doubles * step_ms[n]:.3f} ms; "
                  f"the chain takes {ms:.4f} ms", flush=True)


def check_scans(checks) -> None:
    """The scan kernels at the main path's shapes, padded to whole blocks
    with identity items exactly as ops/msm.py pads them."""
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb, msm

    def items(shape, niels):
        x = checks.rand((*shape, 4, limb.NLIMBS))
        ident = (edwards.identity_niels if niels else edwards.identity)(device=checks.dev)
        flat = x.view(-1, x.shape[-3], 4, limb.NLIMBS)
        flat[0, 0] = 8192  # the largest rows the plain engine hands over
        flat[0, 1] = ident
        flat[-1, 33:40] = ident  # a run of identities inside one block
        return msm._blocked(x, niels=niels)[0]

    for name, label, shape, niels, R, reps in SCAN_CASES:
        x = items(shape, niels)
        kern, ref = getattr(fused, name), getattr(fused, name + "_ref")
        n = x.numel() // (4 * limb.NLIMBS)
        prefix_rows = 0 if name == "add_total" else 4
        n_bytes = (n * (SCAN_ITEM_ROWS[name] + prefix_rows) + n // R * 4) * FE_BYTES
        checks.case(name, f"{label}, {n} items in {n // R} blocks of {R}",
                    lambda: kern(x, R), lambda: ref(x, R), limb.FP, n_bytes,
                    n * SCAN_FIELD_MULS[name] * OPS_PER_FIELD_MUL, reps)


def compress_points(dev, shape) -> torch.Tensor:
    """[*shape, 4, NLIMBS] points for compression: sums of basepoint
    multiples made by K3 (so Z is not 1), with an identity and an all-8192
    row in front."""
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb
    from dusk_blindbidproof_tpu_torch.utils import curve_host as host

    n = int(np.prod(shape))
    base = edwards.from_host([host.ED25519_BASEPOINT.scalar_mul(3 ** k + 5) for k in range(64)],
                             dev)
    idx = torch.arange(n, device=dev)
    pts = fused.add(base[idx % 64], base[(idx // 64 + 7 * idx) % 64])
    pts[0] = edwards.identity(device=dev)
    if n > 1:
        pts[1] = 8192
    return pts.view(*shape, 4, limb.NLIMBS)


def host_compress_ms(points: torch.Tensor) -> float:
    """ms of curve_host's compression of every point, one at a time in host
    integers, as the prover's host path does it (its read included)."""
    from dusk_blindbidproof_tpu_torch.ops import limb
    from dusk_blindbidproof_tpu_torch.utils import curve_host as host

    t0 = time.perf_counter()
    for row in points.reshape(-1, 4, limb.NLIMBS).cpu().numpy():
        host.ristretto_compress(host.EdwardsPoint(*(limb.limbs_to_int(c) for c in row)))
    return (time.perf_counter() - t0) * 1e3


def check_compress(checks) -> None:
    """Ristretto compression at the B = 16 prover's calls, byte for byte
    against its plain version on the CPU."""
    from dusk_blindbidproof_tpu_torch.ops import fused

    for shape, label in (((16, 8), "the commitments V"), ((16, 2), "an IPA round's L and R")):
        pts = compress_points(checks.dev, shape)
        n = pts.numel() // (4 * pts.shape[-1])
        checks.case("compress", f"{label}, {n} points", lambda: fused.compress(pts),
                    lambda: fused.compress_ref(pts.cpu()).to(checks.dev), None,
                    n * COMPRESS_BYTES, n * COMPRESS_OPS, 50)
        print(f"  the host's per-point compression of the same {n} points: "
              f"{host_compress_ms(pts):.3f} ms", flush=True)


def witness_inputs(reqs, dev):
    """The committed values and publics of the requests as prove_batch makes
    them: [n, 4 + L, NLIMBS] and [n, 3 + L, NLIMBS] limbs on `dev`."""
    from dusk_blindbidproof_tpu_torch.ops import limb
    from dusk_blindbidproof_tpu_torch.utils.curve_host import L

    n, list_len = len(reqs), len(reqs[0].pub_list)
    v = limb.ints_to_limbs_fast(
        [x % L for r in reqs for x in [r.d, r.k, r.y, r.y_inv]
         + [int(i == r.toggle) for i in range(list_len)]], (n, 4 + list_len))
    publics = limb.ints_to_limbs_fast(
        [x % L for r in reqs for x in [r.q, r.z_img, r.seed] + list(r.pub_list)],
        (n, 3 + list_len))
    return torch.from_numpy(v).to(dev), torch.from_numpy(publics).to(dev)


def check_witness(checks) -> None:
    """Phase 2b: the witness kernels at WITNESS_CASES, each launch
    synchronised (the wrapper raises on its cudaGetLastError code), the
    wires exact against the plain version on the CPU (blindbid_witness's
    wires as limbs), two launches a wrapper call; each kernel timed apart as
    in phase 2, beside the plain version's time for the whole witness."""
    from dusk_blindbidproof_tpu_torch.models import blindbid
    from dusk_blindbidproof_tpu_torch.models.gadgets import blindbid_n_pad
    from dusk_blindbidproof_tpu_torch.ops import fused

    dev = checks.dev
    consts = blindbid.mimc_constants_limbs(dev)
    for B, list_len, rows in WITNESS_CASES:
        reqs = requests(B, request_inputs if list_len == 4 else full_list_inputs)
        reqs = reqs if rows is None else reqs[rows]
        v, publics = witness_inputs(reqs, dev)
        n, n_pad = len(reqs), blindbid_n_pad(list_len)
        label = f"B = {B}, {list_len} bids" + (
            "" if rows is None else f", a rank's rows {rows.start} to {rows.stop - 1}")
        before = fused.launch_counts()
        scratch = fused.mimc_chain(v, publics, consts)
        torch.cuda.synchronize()
        got = fused.witness_fanout(v, publics, scratch, n_pad, list_len)
        torch.cuda.synchronize()
        whole = blindbid.witness_wires(v, publics, consts, n_pad)
        torch.cuda.synchronize()
        after = fused.launch_counts()
        if any(after[k] - before[k] != (2 if k in WITNESS_KERNELS else 0) for k in after):
            fail(f"witness ({label}): launches {({k: after[k] - before[k] for k in after})}")
        t0 = time.perf_counter()
        want = blindbid.witness_wires_ref(v.cpu(), publics.cpu(), consts.cpu(), n_pad)
        plain = (time.perf_counter() - t0) * 1e3
        for g in (got, whole):
            if tuple(g.shape) != tuple(want.shape) or not torch.equal(g.cpu(), want):
                fail(f"witness ({label}) disagrees with its plain version")
        del got, whole, want
        fe = FE_BYTES
        cases = (
            ("mimc_chain", lambda: fused.mimc_chain(v, publics, consts),
             n * (fused.MIMC_SCRATCH_ROWS + 3) * fe, n * WITNESS_HASH_MULS * OPS_PER_FIELD_MUL),
            ("witness_fanout",
             lambda: fused.witness_fanout(v, publics, scratch, n_pad, list_len),
             n * (3 * n_pad + fused.MIMC_SCRATCH_ROWS + 7 + 2 * list_len) * fe,
             n * (3 * list_len + 2) * OPS_PER_FIELD_MUL),
        )
        for name, kern, n_bytes, n_ops in cases:
            ms = device_ms(kern, WITNESS_REPS)
            eager = cuda_ms(kern, WITNESS_REPS)
            bms, by = bound_ms(n_bytes, n_ops)
            print(f"K {name} ({label}): max abs err 0 (tolerance 0), kernel {ms:.5f} ms "
                  f"({eager:.4f} ms a call in an eager loop), plain (the whole witness, on "
                  f"the host) {plain:.3f} ms, bound {bms:.6f} ms ({by})", flush=True)
            row = dict(max_abs_err=0, ms=ms, eager_ms=eager, plain_ms=plain, bound_ms=bms,
                       bound_by=by)
            checks.results.setdefault(name, row)
            checks.rows.append(dict(name=name, label=label, **row))
        del scratch
        torch.cuda.empty_cache()


class PlainWitnessCalls:
    """Inside the `with` block, calls of the plain witness
    (`blindbid.witness_wires_ref`) are counted: on the card there must be none."""

    def __enter__(self):
        from dusk_blindbidproof_tpu_torch.models import blindbid

        self.calls, self._blindbid, self._saved = 0, blindbid, blindbid.witness_wires_ref

        def counting(*args):
            self.calls += 1
            return self._saved(*args)

        blindbid.witness_wires_ref = counting
        return self

    def __exit__(self, *exc_info) -> None:
        self._blindbid.witness_wires_ref = self._saved


def check_witness_launches(counts: dict, plain: PlainWitnessCalls, where: str) -> None:
    """One prove_batch: each witness kernel launched once, the plain version never."""
    got = {k: counts[k] for k in WITNESS_KERNELS}
    if got != dict.fromkeys(WITNESS_KERNELS, 1) or plain.calls:
        fail(f"{where}: witness launches {got} and {plain.calls} plain calls in one "
             "prove_batch (want one launch of each kernel and no plain call)")


# ---------------------------------------------------------------------------
# Phases 3-4: the main path
# ---------------------------------------------------------------------------


def request_inputs(i: int) -> dict:
    """What bidder i knows: its bid's secrets, the seed, the other bids of the
    list and its own place in it."""
    return dict(d=123456789 + 7919 * i, k=987654321 + 104729 * i, seed=55555 + i,
                extra=[1000 + 3 * i + j for j in range(3)], pos=(2 + i) % 4)


def requests(n: int, inputs=request_inputs):
    from dusk_blindbidproof_tpu_torch.models.blindbid import make_prove_request

    out = []
    for i in range(n):
        r = inputs(i)
        out.append(make_prove_request(d=r["d"], k=r["k"], seed=r["seed"],
                                      pub_list_extra=r["extra"], toggle_pos=r["pos"]))
    return out


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


def proof_digest(proof) -> str:
    from dusk_blindbidproof_tpu_torch.models.blindbid import proof_blob

    return hashlib.sha256(proof_blob(proof)).hexdigest()


def main_path_b16(dev) -> tuple[dict, list[float], list[str]]:
    """Returns the launch counts, the s/op of the timed trips and the digests
    of the 16 proofs (rng = default_rng(7), the same in every trip)."""
    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch, verify_batch
    from dusk_blindbidproof_tpu_torch.ops import fused
    from dusk_blindbidproof_tpu_torch.utils import profiling

    B = 16
    reqs = requests(B)

    def round_trip():
        proofs = prove_batch(reqs, rng=np.random.default_rng(7), device=dev)
        oks = verify_batch(verify_requests(reqs, proofs), device=dev)
        torch.cuda.synchronize()
        return oks, proofs

    t0 = time.perf_counter()
    oks, proofs = round_trip()
    if oks != [True] * B:
        fail("B=16 warm-up round trip did not verify")
    digests = [proof_digest(p) for p in proofs]
    warm = time.perf_counter() - t0
    s_per_op = []
    for _ in range(TIMED_TRIPS):
        t0 = time.perf_counter()
        oks, _ = round_trip()
        s_per_op.append((time.perf_counter() - t0) / B)
        if oks != [True] * B:
            fail("B=16 timed round trip did not verify")
    print(f"B=16 s/op over {TIMED_TRIPS} round trips: median {np.median(s_per_op)}, "
          f"min {min(s_per_op)}, max {max(s_per_op)}, all {s_per_op} "
          f"(warm-up {warm:.3f} s)", flush=True)
    profiling.enable()
    profiling.reset()
    fused.reset_launch_counts()
    with PlainWitnessCalls() as plain:
        oks, _ = round_trip()
    counts = fused.launch_counts()
    profiling.enable(False)
    if oks != [True] * B:
        fail("B=16 profiled round trip did not verify")
    check_witness_launches(counts, plain, "B=16")
    print(profiling.report(), flush=True)
    print(f"launches in that round trip: {counts}", flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    over = {k: counts[k] for k, limit in LAUNCH_LIMITS.items() if counts[k] > limit}
    if over:
        fail(f"launches that the chains should have taken over: {over} (limits {LAUNCH_LIMITS})")
    return counts, s_per_op, digests


# ---------------------------------------------------------------------------
# Phase 5: the server
# ---------------------------------------------------------------------------


def load_client():
    """scripts/uds_client_torch.py: the functions that make the request bodies
    and the framed round trip, the ones the script itself uses."""
    spec = importlib.util.spec_from_file_location(
        "uds_client_torch", ROOT / "scripts" / "uds_client_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def session(path: Path) -> tuple[bytes, bytes]:
    """(request payload, response frame) of a recorded session file: the
    response is recorded as it goes over the wire, length prefix included."""
    from dusk_blindbidproof_tpu_torch.utils.tlv import TlvReader

    r = TlvReader(path.read_bytes())
    return r.expect_frame("request"), r.expect_frame("response")


def socket_dir() -> str:
    """A fresh directory whose path leaves room for a socket's name: a Unix
    socket's path holds about 100 bytes."""
    for base in (None, str(ROOT)):
        path = tempfile.mkdtemp(prefix="bb", dir=base)
        if len(path) <= 80:
            return path
        os.rmdir(path)
    fail("no temporary directory with a path short enough for a Unix socket")


def connect(path: str) -> socket.socket:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.settimeout(600)
    s.connect(path)
    return s


def wait_for_socket(path: str, alive, what: str) -> None:
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if not alive():
            fail(f"{what} ended before it listened on its socket")
        if time.perf_counter() - t0 > SERVER_START_TIMEOUT:
            fail(f"{what} did not listen within {SERVER_START_TIMEOUT} s")
        time.sleep(0.01)


class LiveServer:
    """The port's server on an event loop of its own in a background thread.
    The batches the service flushes are recorded by wrapping its `_flush`:
    (kind, size, the list lengths of its requests).
    Leaving the `with` block stops the server, joins the thread and raises
    what the thread raised (a device fault included)."""

    def __init__(self, path: str, dev):
        from dusk_blindbidproof_tpu_torch.server import BatchingService, BlindBidServer

        self.path = path
        self.flushed: list[tuple[str, int, tuple]] = []
        service = BatchingService(device=dev)
        flush = service._flush

        async def recording_flush(key, q):
            lens = tuple(sorted({len(item.pub_list) for item, *_ in q}))
            self.flushed.append((key[0], len(q), lens))
            await flush(key, q)

        service._flush = recording_flush
        self.server = BlindBidServer(path, service)
        self.loop = None
        self.raised = None
        self.thread = threading.Thread(target=self._run, name="blindbid-server", daemon=True)

    def _run(self) -> None:
        async def serve():
            self.loop = asyncio.get_running_loop()
            await self.server.serve_forever()

        try:
            asyncio.run(serve())
        except BaseException as exc:  # handed to the main thread, raised there
            self.raised = exc

    def __enter__(self):
        self.thread.start()
        wait_for_socket(self.path, self.thread.is_alive, "the server's thread")
        return self

    def __exit__(self, *exc_info) -> None:
        if self.thread.is_alive() and self.loop is not None:
            self.loop.call_soon_threadsafe(self.server.stop)
        self.thread.join(timeout=120)
        if self.thread.is_alive():
            fail("the server's thread did not stop")
        if self.raised is not None:
            raise self.raised

    def take_flushed(self) -> list[tuple[str, int, tuple]]:
        out, self.flushed = self.flushed, []
        return out


def clients_at_once(client, path: str, n: int, inputs=request_inputs) -> float:
    """n connections, each with a bidder's own request (`inputs(i)`): every
    prove request goes out before the first answer is read, then every
    connection sends the verify request for its own proof.  Returns the wall
    seconds; raises on an error frame or a proof that is not accepted."""
    bodies = [client.build_prove_body(**inputs(i)) for i in range(n)]
    socks = [connect(path) for _ in range(n)]

    def exchange(opcode, payloads):
        for s, body in zip(socks, payloads):
            s.sendall(client.frame(bytes([opcode]) + body))
        answers = [client.read_frame(s) for s in socks]
        if client.ERROR_FRAME in answers:
            raise RuntimeError(f"error frame for a well-formed opcode-{opcode} request "
                               f"({n} at once)")
        return answers

    try:
        t0 = time.perf_counter()
        proofs = exchange(client.OP_PROVE, [body for body, _ in bodies])
        verdicts = exchange(client.OP_VERIFY, [client.build_verify_body(proof, pub)
                                               for proof, (_, pub) in zip(proofs, bodies)])
        wall = time.perf_counter() - t0
    finally:
        for s in socks:
            s.close()
    if verdicts != [b"\x01"] * n:
        raise RuntimeError(f"{n} at once: not every proof verified: {verdicts}")
    return wall


def hostile_requests(client) -> dict[str, bytes]:
    """The HOSTILE requests as payloads (opcode byte and body), each
    well-formed on the wire: a verify proof's points are the Ristretto
    basepoint's encoding (A_I1 odd in the last) and its scalars canonical; the
    prove request's publics are consistent, its own bid at place 0."""
    from dusk_blindbidproof_tpu_torch import server as srv
    from dusk_blindbidproof_tpu_torch.models.proof_struct import BlindBidProof, R1CSProof
    from dusk_blindbidproof_tpu_torch.models.transcript_protocol import IDENTITY_COMPRESSED
    from dusk_blindbidproof_tpu_torch.utils import curve_host as host

    base = host.ristretto_compress(host.RISTRETTO_BASEPOINT)

    def verify(bids: int, rounds: int, a_i1: bytes = base) -> bytes:
        r1cs = R1CSProof(
            A_I1=a_i1, A_O1=base, S1=base, A_I2=IDENTITY_COMPRESSED,
            A_O2=IDENTITY_COMPRESSED, S2=IDENTITY_COMPRESSED,
            T_1=base, T_3=base, T_4=base, T_5=base, T_6=base,
            t_x=1, t_x_blinding=2, e_blinding=3,
            ipp_L=[base] * rounds, ipp_R=[base] * rounds, ipp_a=4, ipp_b=5)
        proof = BlindBidProof(r1cs=r1cs, commitments=[base] * 4, t_c=[base] * bids)
        pub = dict(q=7, z_img=8, seed=9, pub_list=[1000 + i for i in range(bids)])
        return bytes([client.OP_VERIFY]) + client.build_verify_body(srv.encode_proof(proof), pub)

    def prove(bids: int) -> bytes:
        inputs = request_inputs(0)
        body, _ = client.build_prove_body(
            d=inputs["d"], k=inputs["k"], seed=inputs["seed"],
            extra=[1000 + i for i in range(bids - 1)], pos=0)
        return bytes([client.OP_PROVE]) + body

    payloads = [
        verify(OVER_CAPACITY_BIDS, 12),
        prove(OVER_CAPACITY_BIDS),
        verify(0, 11),
        verify(4, 10),
        verify(4, 11, a_i1=bytes([base[0] | 1]) + base[1:]),
        prove(LONG_LIST_BIDS),
        verify(LONG_LIST_BIDS, 16),
    ]
    return dict(zip(HOSTILE, payloads))


def hostile_step(client, live, path: str, card: str) -> None:
    """Phase 5a's hostile requests on one connection: each must answer
    exactly the error frame with no kernel launched in between (the counts
    read before and after each) and leave the server without a fault.  The
    wall time of each answer is printed beside the card."""
    from dusk_blindbidproof_tpu_torch.ops import fused

    report = []
    with connect(path) as s:
        for name, payload in hostile_requests(client).items():
            before = fused.launch_counts()
            t0 = time.perf_counter()
            answer = client.send_frame(s, payload)
            ms = (time.perf_counter() - t0) * 1e3
            after = fused.launch_counts()
            launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            if answer != client.ERROR_FRAME:
                fail(f"hostile request '{name}' answered {answer[:16]!r}, not the error frame")
            if launched:
                fail(f"hostile request '{name}' launched kernels: {launched}")
            if live.server.fault is not None:
                fail(f"hostile request '{name}' left a fault: {live.server.fault!r}")
            report.append(f"{name} {ms} ms")
    print(f"server: hostile requests each answered 0xff with 0 launches, no fault "
          f"({card}): {'; '.join(report)}; flushed {live.take_flushed()}", flush=True)


def server_in_process(dev, s_per_op_direct: float, card: str) -> dict:
    from dusk_blindbidproof_tpu_torch import server as srv
    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch
    from dusk_blindbidproof_tpu_torch.ops import fused

    client = load_client()
    prove_req, prove_resp = session(SESSION_PROVE)
    verify_req, verify_resp = session(SESSION_VERIFY)

    # without the socket: the recorded request and rng give the recorded bytes
    parsed = srv.parse_prove_request(prove_req[1:])
    proofs = prove_batch([parsed], rng=np.random.default_rng(RECORDED_RNG_SEED), device=dev)
    if client.frame(srv.encode_proof(proofs[0])) != prove_resp:
        fail("the recorded prove request with the recorded rng does not give the recorded proof")
    # the event loop parses one request after another while a window is open
    t0 = time.perf_counter()
    for _ in range(PARSE_REPS):
        srv.parse_prove_request(prove_req[1:])
    t1 = time.perf_counter()
    for _ in range(PARSE_REPS):
        srv.parse_verify_request(verify_req[1:])
    t2 = time.perf_counter()
    print(f"server: parse -> prove_batch(rng = default_rng(2026)) -> encode equals the "
          f"recorded prove response; parsing on the host takes {(t1 - t0) / PARSE_REPS * 1e3:.3f} ms "
          f"a prove request and {(t2 - t1) / PARSE_REPS * 1e3:.3f} ms a verify request "
          f"(window {srv.BatchingService().window * 1e3:.0f} ms)", flush=True)

    tmp = socket_dir()
    path = os.path.join(tmp, "bb.sock")
    fused.reset_launch_counts()
    try:
        with LiveServer(path, dev) as live:
            with connect(path) as s:
                # 1. a proof the JAX package made
                got = client.send_frame(s, verify_req)
                if client.frame(got) != verify_resp or got != b"\x01":
                    fail(f"the recorded verify request answered {got!r}, recorded {verify_resp!r}")
                # 2. the recorded prove request, its proof sent back, a changed seed
                proof = srv.decode_proof(client.send_frame(s, prove_req))
                if (len(proof.commitments), len(proof.t_c)) != (4, 4):
                    fail("the proof over the socket has the wrong number of commitments")
                pub = dict(q=parsed.q, z_img=parsed.z_img, seed=parsed.seed,
                           pub_list=parsed.pub_list)
                frame = srv.encode_proof(proof)
                ok = client.request(s, client.OP_VERIFY, client.build_verify_body(frame, pub))
                pub["seed"] += 1
                bad = client.request(s, client.OP_VERIFY, client.build_verify_body(frame, pub))
                if (ok, bad) != (b"\x01", b"\x00"):
                    fail(f"verify over the socket gave {ok!r}, and {bad!r} for a changed seed")
            with connect(path) as s:
                # 3. bad requests answer the error frame and the daemon lives
                answers = [client.send_frame(s, p) for p in (b"\x09", prove_req[:40], verify_req)]
                if answers != [srv.ERROR_FRAME, srv.ERROR_FRAME, b"\x01"]:
                    fail(f"bad opcode, short prove body, valid verify answered {answers}")
            print(f"server: recorded verify -> recorded bytes; prove -> 4 + 4 commitments, "
                  f"verify 0x01, changed seed 0x00; bad opcode and short body 0xff, then 0x01; "
                  f"flushed {live.take_flushed()}", flush=True)
            # 4. hostile requests, then the same server goes on
            hostile_step(client, live, path, card)
            # 5. concurrent clients
            sizes_seen, walls = [], {}
            before = fused.launch_counts()
            for n in CLIENTS_AT_ONCE:
                wall = walls[n] = clients_at_once(client, path, n)
                flushed = live.take_flushed()
                after = fused.launch_counts()
                for kind in ("prove", "verify"):
                    sizes = [size for k, size, _ in flushed if k == kind]
                    if sum(sizes) != n or max(sizes) > MAX_BATCH:
                        fail(f"{n} at once: {kind} batches {sizes}")
                    sizes_seen += sizes
                print(f"server: {n} at once all verify: flushed {flushed}, wall {wall:.4f} s, "
                      f"{wall / n} s/op (direct B=16: {s_per_op_direct}); launches "
                      f"{ {k: after[k] - before[k] for k in after} }", flush=True)
                before = after
            if not any(size & (size - 1) for size in sizes_seen):
                fail(f"no batch that is not a power of two was flushed: {sizes_seen}")
        if live.server.fault is not None:
            fail(f"the server kept a device fault: {live.server.fault!r}")
        print(f"hostile: {len(HOSTILE)} requests answered 0xff with 0 launches, server "
              f"alive; then {MAX_BATCH} at once verified in {walls[MAX_BATCH]:.4f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = fused.launch_counts()
    print(f"server: launches of phase 5a: {counts}", flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched behind the server: {missing}")
    return counts


def server_entry_point(card: str) -> None:
    """`python -m dusk_blindbidproof_tpu_torch.server` with no --device."""
    client = load_client()
    tmp = socket_dir()
    path = os.path.join(tmp, "bb.sock")
    log_path = os.path.join(tmp, "server.log")
    try:
        with open(log_path, "wb") as log:
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", "dusk_blindbidproof_tpu_torch.server", "--bind-path", path],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            wait_for_socket(path, lambda: proc.poll() is None, "the server process")
            with connect(path) as s:
                listening = time.perf_counter() - t0
                client.prove_verify(s, *client.build_prove_body(**request_inputs(0)))
                answered = time.perf_counter() - t0
                hostile = hostile_requests(client)
                refusal_ms = {}
                for name in (HOSTILE[0], "prove, 20000 bids"):
                    t1 = time.perf_counter()
                    over = client.send_frame(s, hostile[name])
                    refusal_ms[name] = (time.perf_counter() - t1) * 1e3
                    if over != client.ERROR_FRAME:
                        fail(f"the server process answered '{name}' with {over[:16]!r}")
            # the same 16 at once as in phase 5a, the client now in another
            # process than the server's event loop
            wall = clients_at_once(client, path, MAX_BATCH)
            if proc.poll() is not None:
                fail(f"the server process ended with {proc.returncode} after answering")
            proc.terminate()
            rc = proc.wait(timeout=60)
        except BaseException:
            print(Path(log_path).read_text(errors="replace")[-4000:], flush=True)
            raise
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        if rc != -signal.SIGTERM:
            print(Path(log_path).read_text(errors="replace")[-4000:], flush=True)
            fail(f"the terminated server process exited with {rc}")
        print(f"server: python -m dusk_blindbidproof_tpu_torch.server listened after "
              f"{listening:.2f} s (kernel library already built), prove + verify answered "
              f"at {answered:.2f} s, then 0xff to "
              f"{'; '.join(f'{k!r} in {v} ms' for k, v in refusal_ms.items())} ({card}), "
              f"then {MAX_BATCH} at once all verify in {wall:.4f} s, {wall / MAX_BATCH} "
              f"s/op; alive until terminated", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def scripts_on_card() -> None:
    """Phase 5c: the scripts a user runs, started together as subprocesses
    (each in a session of its own, so that a timeout ends its whole tree);
    each must exit 0, the oracle comparison with "ALL OK"."""
    runs = {
        "scripts/test-uds-torch.sh": (["bash", "scripts/test-uds-torch.sh"], ""),
        "scripts/oracle_compare_torch.py 8": (
            [sys.executable, "scripts/oracle_compare_torch.py", "8"], "RESULT: ALL OK"),
        "scripts/record_session_torch.py": (
            [sys.executable, "scripts/record_session_torch.py"], ""),
    }
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True, start_new_session=True)
             for name, (cmd, _) in runs.items()}
    try:
        for name, proc in procs.items():
            try:
                out, _ = proc.communicate(timeout=max(1.0, SCRIPT_TIMEOUT - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                fail(f"{name} did not end within {SCRIPT_TIMEOUT} s")
            tail = "\n  ".join(out.strip().splitlines()[-6:])
            print(f"script {name}: exit {proc.returncode}, read {time.perf_counter() - t0:.2f} s "
                  f"after the three started\n  {tail}", flush=True)
            if proc.returncode != 0 or runs[name][1] not in out:
                print(out[-4000:], flush=True)
                fail(f"{name} exited with {proc.returncode}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()


# ---------------------------------------------------------------------------
# Phase 6: the mesh on the one card
# ---------------------------------------------------------------------------


def mesh_rank(dev, digests: list[str]) -> dict:
    """One rank of phase 6 (module level: the ranks import it by name).
    Raises on any disagreement, which fails the job."""
    import torch.distributed as dist

    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch, verify_batch
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb, msm
    from dusk_blindbidproof_tpu_torch.parallel import mesh as pmesh
    from dusk_blindbidproof_tpu_torch.utils import curve_host as host

    out = {"entered": time.time()}
    meshes = {layout: pmesh.make_mesh(bids=layout[0], points=layout[1], device=dev)
              for layout in (*MESH_LAYOUTS, (1, MESH_RANKS))}
    out["ready"] = time.time()
    reqs = requests(16)
    reqs_config4 = requests(CONFIG4_BATCH)

    def check(cond, what):
        if not cond:
            raise AssertionError(f"rank {dist.get_rank()}: {what}")

    def round_trip(mesh, n, batch=reqs):
        proofs = prove_batch(batch[:n], rng=np.random.default_rng(7), mesh=mesh)
        oks = verify_batch(verify_requests(batch[:n], proofs), mesh=mesh)
        torch.cuda.synchronize()
        return proofs, oks

    # inputs of the MSM cases, made before the counted run: the 4096 G and H
    # generators (hash-derived points) and 64 random multiples of the basepoint
    gen = np.random.default_rng(MESH_MSM_SEED)
    gens = edwards.from_host(msm._host_points(2048)[:4096], device=dev)
    gen_scalars = [int.from_bytes(gen.bytes(32), "little") % host.L for _ in range(4096)]
    small_host = [host.ED25519_BASEPOINT.scalar_mul(int.from_bytes(gen.bytes(32), "little") % host.L)
                  for _ in range(64)]
    small_scalars = [int.from_bytes(gen.bytes(32), "little") % host.L for _ in range(64)]
    bucket_pts = gens.reshape(4, 1024, 4, limb.NLIMBS).repeat(1, 4, 1, 1)  # [4, 4096, 4, NL]
    bucket_digits = torch.from_numpy(
        gen.integers(0, msm.D_BUCKETS, size=(4, 4096)).astype(np.int32)).to(dev)

    torch.cuda.synchronize()
    dist.barrier()
    fused.reset_launch_counts()
    for layout, bad in MESH_LAYOUTS.items():
        mesh = meshes[layout]
        proofs, oks = round_trip(mesh, 16)
        check([proof_digest(p) for p in proofs] == digests,
              f"{layout}: proofs differ from the unsharded ones of phase 4")
        check(oks == [True] * 16, f"{layout}: verify gave {oks}")
        vreqs = verify_requests(reqs, proofs)
        vreqs[bad].seed += 1
        got = verify_batch(vreqs, mesh=mesh)
        check(got == [i != bad for i in range(16)], f"{layout}: wrong seed at {bad} gave {got}")
        trips = []
        for trip in range(MESH_TRIPS):
            before = fused.launch_counts()
            dist.barrier()
            t0 = time.perf_counter()
            _, oks = round_trip(mesh, 16)
            dist.barrier()
            trips.append((time.perf_counter() - t0) / 16)
            check(oks == [True] * 16, f"{layout}: timed round trip gave {oks}")
            if trip == 0:
                after = fused.launch_counts()
                out[f"trip_launches {layout}"] = {k: after[k] - before[k] for k in after}
        out[f"s_per_op {layout}"] = trips
    for n in MESH_UNEVEN_B:
        proofs, oks = round_trip(meshes[(4, 1)], n)
        check([proof_digest(p) for p in proofs] == digests[:n] and oks == [True] * n,
              f"B = {n} at (4, 1): proofs or verdicts differ")
    # config 4: phase 9 holds these digests to its direct ones
    n, mesh = CONFIG4_BATCH, meshes[CONFIG4_MESH_LAYOUT]
    proofs, oks = round_trip(mesh, n, reqs_config4)
    check(oks == [True] * n, f"B = {n} at {CONFIG4_MESH_LAYOUT}: verify gave {oks}")
    out["config4 digests"] = [proof_digest(p) for p in proofs]
    del proofs
    dist.barrier()
    t0 = time.perf_counter()
    _, oks = round_trip(mesh, n, reqs_config4)
    dist.barrier()
    out["config4 s_per_op"] = (time.perf_counter() - t0) / n
    check(oks == [True] * n, f"B = {n} at {CONFIG4_MESH_LAYOUT}: timed round trip gave {oks}")
    m14 = meshes[(1, MESH_RANKS)]
    big = pmesh.sharded_msm(m14, gens, torch.from_numpy(limb.ints_to_limbs(gen_scalars)).to(dev))
    small = pmesh.sharded_msm(m14, edwards.from_host(small_host, device=dev),
                              torch.from_numpy(limb.ints_to_limbs(small_scalars)).to(dev))
    bucket = pmesh.sharded_bucket_step(meshes[(2, 2)], bucket_pts, bucket_digits)
    pmesh.dryrun_multichip(meshes[(2, 2)])
    torch.cuda.synchronize()
    out["launches"] = fused.launch_counts()

    # references, after the counts were read
    want = msm.msm(gens, torch.from_numpy(limb.ints_to_limbs(gen_scalars)).to(dev))
    check(bool(edwards.eq_points(big, want)), "sharded_msm over 4096 points != msm.msm")
    acc = host.EdwardsPoint.identity()
    for p, k in zip(small_host, small_scalars):
        acc = acc + p.scalar_mul(k)
    check(pmesh._same_point(edwards.to_host(small)[0], acc), "sharded_msm over 64 points != host sum")
    want = msm.bucket_msm(bucket_pts, bucket_digits)
    check(bool(edwards.eq_points(bucket, want).all()), "sharded_bucket_step != bucket_msm")
    out["done"] = time.time()
    return out


def mesh_phase(digests: list[str], s_per_op_direct: float) -> tuple[dict, list[str]]:
    """Returns the launch counts summed over the ranks and the digests of the
    config-4 batch that the ranks proved."""
    from dusk_blindbidproof_tpu_torch.ops import fused
    from dusk_blindbidproof_tpu_torch.parallel import mesh as pmesh

    torch.cuda.empty_cache()
    backend = pmesh.default_backend("cuda:0", MESH_RANKS)
    t0 = time.time()
    ranks = pmesh.spawn(mesh_rank, MESH_RANKS, device="cuda:0", args=(digests,),
                        timeout=MESH_TIMEOUT)
    t1 = time.time()
    print(f"mesh: {MESH_RANKS} ranks on cuda:0 over {backend}: in their function after "
          f"{max(r['entered'] for r in ranks) - t0:.2f} s, meshes made after "
          f"{max(r['ready'] for r in ranks) - t0:.2f} s, job {t1 - t0:.2f} s", flush=True)
    for layout in MESH_LAYOUTS:
        trips = ranks[0][f"s_per_op {layout}"]
        print(f"mesh {layout[0]}x{layout[1]}: 16 proofs = phase 4's bytes, all verify, wrong seed "
              f"rejected at place {MESH_LAYOUTS[layout]} only; s/op over {MESH_TRIPS} round trips "
              f"(rank 0) median {np.median(trips)}, all {trips}; phase 4 direct median "
              f"{s_per_op_direct}", flush=True)
        print(f"mesh {layout[0]}x{layout[1]}: launches of one round trip, by rank: "
              f"{[r[f'trip_launches {layout}'] for r in ranks]}", flush=True)
    print(f"mesh: B = {MESH_UNEVEN_B} at 4x1 = phase 4's first B proofs, all verify; sharded_msm "
          f"over 4096 and 64 points, sharded_bucket_step at 2x2 and dryrun_multichip agree",
          flush=True)
    config4 = [r["config4 digests"] for r in ranks]
    if any(d != config4[0] for d in config4):
        fail("the ranks returned different config-4 batches")
    layout = "x".join(map(str, CONFIG4_MESH_LAYOUT))
    print(f"mesh {layout}: B = {CONFIG4_BATCH} ({CONFIG4_BATCH // CONFIG4_MESH_LAYOUT[0]} bids a "
          f"rank) all verify; one timed round trip {ranks[0]['config4 s_per_op']} s/op (rank 0); "
          f"its digests go to phase 9", flush=True)
    counts = {k: sum(r["launches"][k] for r in ranks) for k in fused.KERNELS}
    print(f"mesh: launches summed over the ranks: {counts}", flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched in the ranks: {missing}")
    return counts, config4[0]


# ---------------------------------------------------------------------------
# Phase 7: the generic R1CS path at n = cap = 2^10 and 2^16
# ---------------------------------------------------------------------------


def chain_inputs(n_pad: int):
    """The circuit and witness of benchmarks/ipa_bench.py:47-69, built with the
    port's models/r1cs.py: one committed input v0 = CHAIN_V0 and n_pad - 1
    gates w_{i+1} = w_i * w_i.  Returns (artifact, a_L, a_R, a_O), the
    witness as python ints."""
    from dusk_blindbidproof_tpu_torch.models.r1cs import LC, VerifierCS
    from dusk_blindbidproof_tpu_torch.utils.curve_host import L

    cs = VerifierCS()
    cur = LC.of(cs.commit_var())
    n_gates = n_pad - 1  # leaves room for padding to the power of two
    for _ in range(n_gates):
        _, _, o = cs.multiply(cur, cur)
        cur = LC.of(o)
    a_L, a_R, a_O = [], [], []
    x = CHAIN_V0
    for _ in range(n_gates):
        a_L.append(x)
        a_R.append(x)
        x = x * x % L
        a_O.append(x)
    return cs.artifact(), a_L, a_R, a_O


def chain_witness(n_pad: int, B: int, a_L, a_R, a_O):
    """The ProverWitness of B proofs of the chain, every row the same (as
    ipa_bench.py has it), no public inputs."""
    from dusk_blindbidproof_tpu_torch.models.bulletproofs import ProverWitness
    from dusk_blindbidproof_tpu_torch.ops import limb

    def rows(vals):
        arr = np.zeros((B, n_pad, limb.NLIMBS), dtype=np.int32)
        arr[:, :len(vals)] = limb.ints_to_limbs_fast(vals)
        return arr

    def scalar(v):
        return np.broadcast_to(limb.ints_to_limbs_fast([v]), (B, 1, limb.NLIMBS)).copy()

    return ProverWitness(a_L=rows(a_L), a_R=rows(a_R), a_O=rows(a_O), v=scalar(CHAIN_V0),
                         v_blinding=scalar(CHAIN_BLIND),
                         publics=np.zeros((B, 0, limb.NLIMBS), dtype=np.int32))


def chain_prove(circuit, witness, cap: int, device):
    """Prover(cap) -> commit_batch -> prove over the witness's rows: returns
    (commitments, proofs)."""
    from dusk_blindbidproof_tpu_torch.models.bulletproofs import Prover
    from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript

    B = witness.a_L.shape[0]
    prover = Prover([Transcript(CHAIN_LABEL) for _ in range(B)], cap=cap, device=device)
    commitments = prover.commit_batch([[CHAIN_V0]] * B, [[CHAIN_BLIND]] * B)
    seed = np.random.default_rng(CHAIN_SEED).bytes(32)
    return commitments, prover.prove(circuit, witness, seed=seed)


def chain_verify(circuit, commitments, proofs, cap: int, device) -> list[bool]:
    """Verifier(cap) -> commit_batch -> verify of the batch."""
    from dusk_blindbidproof_tpu_torch.models.bulletproofs import Verifier
    from dusk_blindbidproof_tpu_torch.ops import limb
    from dusk_blindbidproof_tpu_torch.utils.merlin import Transcript

    B = len(proofs)
    verifier = Verifier([Transcript(CHAIN_LABEL) for _ in range(B)], cap=cap, device=device)
    verifier.commit_batch(commitments)
    return verifier.verify(circuit, proofs, commitments,
                           np.zeros((B, 0, limb.NLIMBS), dtype=np.int32))


def bumped(proof, field: str):
    """A copy of `proof` with its scalar `field` plus one (mod l)."""
    from dusk_blindbidproof_tpu_torch.models.proof_struct import R1CSProof
    from dusk_blindbidproof_tpu_torch.utils.curve_host import L

    out = R1CSProof.from_bytes(proof.to_bytes())
    setattr(out, field, (getattr(out, field) + 1) % L)
    return out


def chain_small(dev) -> None:
    """Phase 7a: n = cap = 2^10, B = 1, against the JAX package's bytes."""
    from dusk_blindbidproof_tpu_torch.models.bulletproofs import CompiledCircuit

    t0 = time.perf_counter()
    artifact, *wit = chain_inputs(CHAIN_SMALL)
    circuit = CompiledCircuit.compile(artifact, dev)
    commitments, proofs = chain_prove(circuit, chain_witness(CHAIN_SMALL, 1, *wit),
                                      CHAIN_SMALL, dev)
    if proofs[0].to_bytes().hex() != FROZEN_CHAIN.read_text().strip():
        fail(f"the n = {CHAIN_SMALL} chain proof differs from {FROZEN_CHAIN.name}")
    oks = chain_verify(circuit, commitments * 2, [proofs[0], bumped(proofs[0], "t_x")],
                       CHAIN_SMALL, dev)
    if oks != [True, False]:
        fail(f"n = {CHAIN_SMALL}: verify gave {oks} for the proof and the one with t_x + 1")
    print(f"chain n = cap = {CHAIN_SMALL}, B = 1: proof bytes equal {FROZEN_CHAIN.name}; "
          f"verify [True], t_x + 1 [False] ({time.perf_counter() - t0:.2f} s incl. tables)",
          flush=True)


# entry functions of csrc/edwards_kernels.cu, as the profiler names them
OWN_KERNELS = ("point_step_kernel", "point_scan_kernel", "point_double_kernel",
               "double_chain_kernel", "mul_rows_kernel", "sqr_chain_kernel",
               "ristretto_compress_kernel", "mimc_chain_kernel", "witness_fanout_kernel")


def kernel_rows(prof) -> list[dict]:
    """The kernel events of a torch.profiler run, largest device time first
    (kernel events only: the aten ops that launched them carry the same
    device time again)."""
    rows = [
        {"name": e.key, "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
    ]
    rows.sort(key=lambda r: -r["device_ms"])
    return rows


def profiled(fn) -> tuple[list[dict], float]:
    """Runs fn() under torch.profiler (CPU and CUDA activities): (kernel
    rows, wall seconds of the call)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    return kernel_rows(prof), wall


def print_profile(fn, label: str) -> None:
    """`profiled(fn)`, printed: the wall, the device-busy ms and share, then
    the 12 largest kernels and every kernel of the port's own."""
    rows, wall = profiled(fn)
    busy = sum(r["device_ms"] for r in rows)
    own = [r for r in rows if any(k in r["name"] for k in OWN_KERNELS)]
    print(f"{label}: profiled round trip {wall:.4f} s wall, device busy {busy:.1f} ms, share "
          f"{busy / (wall * 1e3)}; the port's own kernels {sum(r['device_ms'] for r in own):.3f} "
          f"ms; the 12 largest, then every own kernel:", flush=True)
    for r in rows[:12] + own:
        print(f"  {r['device_ms']:10.3f} ms  x{r['calls']:<6d} {r['name'][:90]}", flush=True)


def chain_large(dev) -> dict:
    """Phase 7b: n = cap = 2^16 at batch CHAIN_BATCH.  Returns the launch
    counts of the counted round trip."""
    from dusk_blindbidproof_tpu_torch.models.bulletproofs import (
        CompiledCircuit, generator_tables,
    )
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, msm
    from dusk_blindbidproof_tpu_torch.utils import profiling

    n, B = CHAIN_LARGE, CHAIN_BATCH
    t0 = time.perf_counter()
    artifact, *wit = chain_inputs(n)
    t1 = time.perf_counter()
    circuit = CompiledCircuit.compile(artifact, dev)
    witness = chain_witness(n, B, *wit)
    t2 = time.perf_counter()
    points = msm._host_points(n)  # G | H | B | B_blinding, derived on the host
    t3 = time.perf_counter()
    edwards.from_host(points)  # their limbs, on the host alone
    t4 = time.perf_counter()
    generator_tables(n, dev)
    torch.cuda.synchronize()
    t5 = time.perf_counter()
    tables_gb = torch.cuda.memory_allocated() / 1e9
    print(f"chain n = cap = {n}: synthesis {t1 - t0:.2f} s, compile + witness of B = {B} "
          f"{t2 - t1:.2f} s; tables of {len(points)} generators: host derivation "
          f"{t3 - t2:.2f} s, their limbs on the host {t4 - t3:.2f} s, generator_tables "
          f"{t5 - t4:.2f} s (the limbs again, the copy, double_chain and the Niels form); "
          f"{tables_gb:.3f} GB allocated after", flush=True)

    def round_trip():
        commitments, proofs = chain_prove(circuit, witness, n, dev)
        oks = chain_verify(circuit, commitments, proofs, n, dev)
        torch.cuda.synchronize()
        return commitments, proofs, oks

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    commitments, proofs, oks = round_trip()
    warm = time.perf_counter() - t0
    if oks != [True] * B:
        fail(f"chain n = {n}: the warm-up round trip gave {oks}")
    s_per_op = []
    for _ in range(CHAIN_TRIPS):
        t0 = time.perf_counter()
        _, _, oks = round_trip()
        s_per_op.append((time.perf_counter() - t0) / B)
        if oks != [True] * B:
            fail(f"chain n = {n}: a timed round trip gave {oks}")
    print(f"chain n = {n} B = {B}: s/op over {CHAIN_TRIPS} round trips: median "
          f"{np.median(s_per_op)}, min {min(s_per_op)}, max {max(s_per_op)}, all {s_per_op} "
          f"(warm-up {warm:.3f} s)", flush=True)
    bad = B // 2
    got = chain_verify(circuit, commitments,
                       [bumped(p, "ipp_a") if i == bad else p for i, p in enumerate(proofs)],
                       n, dev)
    if got != [i != bad for i in range(B)]:
        fail(f"chain n = {n}: ipp_a + 1 at place {bad} gave {got}")
    del commitments, proofs

    profiling.enable()
    profiling.reset()
    fused.reset_launch_counts()
    round_trip()
    counts = fused.launch_counts()
    profiling.enable(False)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(profiling.report(), flush=True)
    print(f"chain n = {n} B = {B}: every proof verifies, ipp_a + 1 rejected at place {bad} "
          f"only; launches in one round trip: {counts}; peak device memory {peak_gb:.3f} GB "
          f"(torch.cuda.max_memory_allocated over the trips)", flush=True)
    missing = [k for k, v in counts.items() if v == 0 and k not in WITNESS_KERNELS]
    if missing:
        fail(f"kernels never launched at n = {n}: {missing}")

    print_profile(round_trip, f"chain n = {n} B = {B}")
    return counts


def sliced_case(results: dict, counts: dict, name, label, kern, pairs, ctx, n_bytes, n_ops,
                reps, plain_of) -> None:
    """One kernel at a shape too large for its plain version: kern() runs
    the kernel whole; pairs are (pick, ref) with pick(kernel output) and
    ref() the same tensors from the plain version on a slice, held exact
    against canon(plain).  The plain time is that of the compared calls
    (one each: a plain chain takes seconds); the kernel's is timed as in
    phase 2.  Appends a row to results[name]."""
    from dusk_blindbidproof_tpu_torch.ops import limb

    got = kern()
    err, plain = 0, 0.0
    for pick, ref in pairs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = ref()
        torch.cuda.synchronize()
        plain += (time.perf_counter() - t0) * 1e3
        mine = pick(got)
        mine, want = ((mine,), (want,)) if isinstance(want, torch.Tensor) else (mine, want)
        for g, w in zip(mine, want):
            if g.shape != w.shape:
                fail(f"{name} ({label}): shape {tuple(g.shape)} != {tuple(w.shape)}")
            err = max(err, int((g - canon_of(ctx, w)).abs().max()))
    if err:
        fail(f"{name} ({label}) disagrees with its plain version (max abs err {err})")
    del got
    ms = device_ms(kern, reps)
    bms, by = bound_ms(n_bytes, n_ops)
    row = dict(label=label, ms=ms, bound_ms=bms, bound_by=by, plain_ms=plain,
               plain_of=plain_of, launches=counts[name])
    results.setdefault(name, []).append(row)
    print(f"K {name} ({label}): max abs err 0 (tolerance 0), kernel {ms:.5f} ms, bound "
          f"{bms:.6f} ms ({by}), plain {plain:.3f} ms on {plain_of}; "
          f"{counts[name]} launches a round trip", flush=True)


def check_large_kernels(dev, counts: dict) -> dict:
    """Phase 7c: the kernels at phase 7b's shapes, exact against
    canon(plain).  The scans and the chain are compared on LARGE_SLICE blocks
    or points at each end of their rows (the first row's head, with the
    all-8192 and identity items, and the last row's tail, with the padding);
    the plain versions over all of it would take minutes.  Returns the rows
    by kernel."""
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb, msm

    n, B, nl, R = CHAIN_LARGE, CHAIN_BATCH, limb.NLIMBS, BLOCK_R
    gen = torch.Generator(device=dev)
    gen.manual_seed(2016)
    results: dict[str, list] = {}

    def rand(shape):
        return torch.randint(0, 8193, shape, dtype=torch.int32, device=dev, generator=gen)

    def scan_items(shape):
        x = rand((*shape, 4, nl))
        ident = edwards.identity_niels(device=dev)
        flat = x.view(-1, shape[-1], 4, nl)
        flat[0, 0] = 8192
        flat[0, 1] = ident
        flat[-1, -40:-33] = ident
        return msm._blocked(x, niels=True)[0]

    # madd_scan: phase A's three MSMs, one at a time, and an IPA round's L and R
    for label, shape in (("phase A, one of its three MSMs", (B, (2 * n + 2) * WINDOWS)),
                         ("IPA round, L and R", (B, 2, (n + 1) * WINDOWS))):
        x = scan_items(shape)
        flat = x.view(-1, x.shape[-3], 4, nl)
        m = x.numel() // (4 * nl)
        C, S = flat.shape[1] // R, LARGE_SLICE
        ends = ((0, 0, S), (flat.shape[0] - 1, C - S, C))

        def pick(got, b, c0, c1):
            within, totals = got
            return (within.view(flat.shape)[b, c0 * R:c1 * R],
                    totals.view(flat.shape[0], C, 4, nl)[b, c0:c1])

        pairs = [(lambda got, b=b, c0=c0, c1=c1: pick(got, b, c0, c1),
                  lambda b=b, c0=c0, c1=c1: fused.madd_scan_ref(flat[b, c0 * R:c1 * R], R))
                 for b, c0, c1 in ends]
        sliced_case(results, counts, "madd_scan", f"{label}, {m} items in {m // R} blocks of {R}",
             lambda: fused.madd_scan(x, R), pairs, limb.FP,
             (m * (SCAN_ITEM_ROWS["madd_scan"] + 4) + m // R * 4) * FE_BYTES,
             m * SCAN_FIELD_MULS["madd_scan"] * OPS_PER_FIELD_MUL, 3,
             f"2 x {S} blocks")
        del x, flat

    # double_chain: the generator tables' points
    npts = 2 * n + 2
    p = rand((npts, 4, nl))
    p[0] = 8192
    p[1] = edwards.identity(device=dev)
    ends = torch.cat([torch.arange(LARGE_SLICE, device=dev),
                      torch.arange(npts - LARGE_SLICE, npts, device=dev)])
    doubles = (WINDOWS - 1) * WINDOW_STEPS
    sliced_case(results, counts, "double_chain", f"generator tables, {npts} points x {WINDOWS} windows x "
         f"{WINDOW_STEPS} steps", lambda: fused.double_chain(p, WINDOWS, WINDOW_STEPS),
         [(lambda got: got[ends],
           lambda: fused.double_chain_ref(p[ends], WINDOWS, WINDOW_STEPS))], limb.FP,
         npts * (1 + WINDOWS) * 4 * FE_BYTES,
         npts * (doubles * OPS_PER_DOUBLE_XYZ + (WINDOWS - 1) * OPS_PER_FIELD_MUL), 3,
         f"2 x {LARGE_SLICE} points")
    del p

    # K1 mod l: the IPA fold's and verify_scalars' B x n rows, compared whole
    a, b = rand((B, n, nl)), rand((B, n, nl))
    a[0, 0], b[0, 0] = 8192, 8192
    a[0, 1], b[0, 2] = 0, 0
    rows = B * n
    sliced_case(results, counts, "mul_rows_fl", f"IPA fold, {rows} rows", lambda: fused.mul_rows(limb.FL, a, b),
         [(lambda got: got, lambda: fused.mul_rows_ref(limb.FL, a, b))], limb.FL,
         rows * 3 * FE_BYTES, rows * OPS_PER_FIELD_MUL, 20, f"all {rows} rows")

    # compress: an IPA round's L and R of the batch
    pts = compress_points(dev, (B, 2))
    sliced_case(results, counts, "compress", f"IPA round, {2 * B} points",
                lambda: fused.compress(pts),
                [(lambda got: got, lambda: fused.compress_ref(pts.cpu()).to(dev))], None,
                2 * B * COMPRESS_BYTES, 2 * B * COMPRESS_OPS, 50, f"all {2 * B} points")
    return results


# ---------------------------------------------------------------------------
# Phase 8: BlindBid at the full list
# ---------------------------------------------------------------------------


def full_list_inputs(i: int) -> dict:
    """Bidder i of a 202-bid list.  Bidder 0's request is the one of
    tests/data/blindbid_L202_seed42.hex: its bid at place 101, the other 201
    bids 1000, 1001, ..."""
    return dict(d=123456789 + 7919 * i, k=987654321 + 104729 * i, seed=55555 + i,
                extra=[1000 + 3 * i + j for j in range(FULL_LIST - 1)],
                pos=(101 + 13 * i) % FULL_LIST)


class LeafScans:
    """Inside the `with` block, `msm._bucket_scan_rows` (the leaf scan of
    every bucket MSM) is wrapped: each call records whether its items were
    affine-Niels, their shape and the add_scan launches it made, and the
    extended-point items of the last such call are kept."""

    def __enter__(self):
        from dusk_blindbidproof_tpu_torch.ops import fused, msm

        self.calls: list[tuple[bool, tuple, int]] = []
        self.leaf = None
        self._msm, self._scan = msm, msm._bucket_scan_rows

        def recording(pts_sorted, niels):
            before = fused.launch_counts()["add_scan"]
            out = self._scan(pts_sorted, niels)
            self.calls.append((niels, tuple(pts_sorted.shape),
                               fused.launch_counts()["add_scan"] - before))
            if not niels:
                self.leaf = pts_sorted
            return out

        msm._bucket_scan_rows = recording
        return self

    def __exit__(self, *exc_info) -> None:
        self._msm._bucket_scan_rows = self._scan


def full_list_b1(dev) -> None:
    """Phase 8a: the frozen 202-bid proof."""
    from dusk_blindbidproof_tpu_torch.models.blindbid import (
        proof_blob, prove_batch, verify_batch,
    )

    reqs = requests(1, full_list_inputs)
    t0 = time.perf_counter()
    proofs = prove_batch(reqs, rng=np.random.default_rng(42), device=dev)
    t1 = time.perf_counter()
    if proof_blob(proofs[0]).hex() != FROZEN_FULL_LIST.read_text().strip():
        fail(f"B=1 proof at {FULL_LIST} bids differs from {FROZEN_FULL_LIST.name}")
    ok = verify_batch(verify_requests(reqs, proofs), device=dev)
    bad = verify_batch(verify_requests(reqs, proofs, seed_bump=1), device=dev)
    t2 = time.perf_counter()
    if ok != [True] or bad != [False]:
        fail(f"B=1 at {FULL_LIST} bids: verify gave {ok} for the proof and {bad} for a wrong seed")
    print(f"full list, {FULL_LIST} bids, B=1: proof bytes equal {FROZEN_FULL_LIST.name} "
          f"({len(proofs[0].commitments) + len(proofs[0].t_c)} commitments); verify [True], "
          f"wrong seed [False] (first prove {t1 - t0:.3f} s incl. the circuit, verify x2 "
          f"{t2 - t1:.3f} s)", flush=True)


def full_list_b16(dev, counts_l4: dict, s_per_op_l4: list[float]):
    """Phase 8b.  Returns (launch counts of the counted round trip, s/op of
    the timed trips, the verifier's dynamic-MSM leaf items)."""
    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch, verify_batch
    from dusk_blindbidproof_tpu_torch.ops import fused, limb
    from dusk_blindbidproof_tpu_torch.utils import profiling

    B = FULL_LIST_BATCH
    reqs = requests(B, full_list_inputs)

    def round_trip():
        proofs = prove_batch(reqs, rng=np.random.default_rng(7), device=dev)
        oks = verify_batch(verify_requests(reqs, proofs), device=dev)
        torch.cuda.synchronize()
        return oks, proofs

    t0 = time.perf_counter()
    oks, proofs = round_trip()
    warm = time.perf_counter() - t0
    if oks != [True] * B:
        fail(f"B={B} at {FULL_LIST} bids: the warm-up round trip gave {oks}")
    vreqs = verify_requests(reqs, proofs)
    vreqs[FULL_LIST_BAD].seed += 1
    got = verify_batch(vreqs, device=dev)
    if got != [i != FULL_LIST_BAD for i in range(B)]:
        fail(f"B={B} at {FULL_LIST} bids: a wrong seed at place {FULL_LIST_BAD} gave {got}")
    s_per_op = []
    for _ in range(TIMED_TRIPS):
        t0 = time.perf_counter()
        oks, _ = round_trip()
        s_per_op.append((time.perf_counter() - t0) / B)
        if oks != [True] * B:
            fail(f"B={B} at {FULL_LIST} bids: a timed round trip gave {oks}")
    print(f"full list B={B}: s/op over {TIMED_TRIPS} round trips: median {np.median(s_per_op)}, "
          f"min {min(s_per_op)}, max {max(s_per_op)}, all {s_per_op} (warm-up {warm:.3f} s); "
          f"phase 4 at 4 bids: median {np.median(s_per_op_l4)}, all {s_per_op_l4}; every proof "
          f"verifies, a wrong seed rejected at place {FULL_LIST_BAD} only", flush=True)

    profiling.enable()
    profiling.reset()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    with LeafScans() as scans:
        proofs = prove_batch(reqs, rng=np.random.default_rng(7), device=dev)
        torch.cuda.synchronize()
        prove_counts = fused.launch_counts()
        oks = verify_batch(verify_requests(reqs, proofs), device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = fused.launch_counts()
    profiling.enable(False)
    if oks != [True] * B:
        fail(f"B={B} at {FULL_LIST} bids: the counted round trip gave {oks}")
    print(profiling.report(), flush=True)
    print(f"full list B={B}: counted round trip {wall:.4f} s wall; launches {counts}; of them "
          f"the verifier's {({k: counts[k] - prove_counts[k] for k in counts})}; phase 4 "
          f"at 4 bids {counts_l4}", flush=True)
    print(f"full list B={B}: bucket MSMs of the round trip (affine-Niels items, shape, "
          f"add_scan launches): {scans.calls}", flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched at {FULL_LIST} bids: {missing}")
    dynamic = (B, FULL_LIST_POINTS * WINDOWS, 4, limb.NLIMBS)
    if not any(not niels and shape == dynamic and n >= 1 for niels, shape, n in scans.calls):
        fail(f"the verifier's dynamic MSM over {dynamic} did not launch add_scan: {scans.calls}")
    over = {k: (counts[k], counts_l4[k]) for k in LAUNCH_LIMITS if counts[k] > counts_l4[k]}
    if over:
        fail(f"one-step launches above phase 4's at {FULL_LIST} bids: {over}")

    print_profile(round_trip, f"full list B={B}")
    return counts, s_per_op, scans.leaf


def check_full_list_kernels(dev, leaf: torch.Tensor, counts: dict) -> list[dict]:
    """Phase 8c: the kernels at 8b's shapes.  Returns every case's row."""
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb, msm

    checks = KernelChecks(dev)
    nl, R = limb.NLIMBS, BLOCK_R

    # add_scan as the leaf of the verifier's dynamic MSM, on its own items
    special = leaf.clone()
    flat = special.view(-1, special.shape[-3], 4, nl)
    flat[0, 0] = 8192
    flat[0, 1] = edwards.identity(device=dev)
    flat[-1, 33:40] = edwards.identity(device=dev)
    for label, items in (("the verifier's leaf items", leaf),
                         ("the same with all-8192 and identity rows", special)):
        x = msm._blocked(items)[0]
        n = x.numel() // (4 * nl)
        checks.case("add_scan", f"dynamic MSM leaf, {label}, {n} items in {n // R} blocks of {R}",
                    lambda: fused.add_scan(x, R), lambda: fused.add_scan_ref(x, R), limb.FP,
                    (n * (SCAN_ITEM_ROWS["add_scan"] + 4) + n // R * 4) * FE_BYTES,
                    n * SCAN_FIELD_MULS["add_scan"] * OPS_PER_FIELD_MUL, 20)
    del special, flat

    npts = leaf.shape[0] * FULL_LIST_POINTS
    p = checks.rand((npts, 4, nl))
    p[0] = 8192
    p[1] = edwards.identity(device=dev)
    doubles = (WINDOWS - 1) * WINDOW_STEPS
    checks.case("double_chain",
                f"verifier, {npts} points x {WINDOWS} windows x {WINDOW_STEPS} steps",
                lambda: fused.double_chain(p, WINDOWS, WINDOW_STEPS),
                lambda: fused.double_chain_ref(p, WINDOWS, WINDOW_STEPS), limb.FP,
                npts * (1 + WINDOWS) * 4 * FE_BYTES,
                npts * (doubles * OPS_PER_DOUBLE_XYZ + (WINDOWS - 1) * OPS_PER_FIELD_MUL), 10)

    x = checks.rand((npts, nl))
    x[0], x[1] = 8192, 0
    x[2] = torch.from_numpy(limb.int_to_limbs(1)).to(dev)
    for k in SQR_CHAIN_K:
        checks.case("sqr_chain", f"decompression, {npts} rows, k = {k}",
                    lambda: fused.sqr_chain(limb.FP, x, k),
                    lambda: fused.sqr_chain_ref(limb.FP, x, k), limb.FP,
                    npts * 2 * FE_BYTES, npts * k * OPS_PER_FIELD_SQR, 50)

    rows = (leaf.shape[0], FULL_LIST_POINTS, nl)
    a, b = checks.rand(rows), checks.rand(rows)
    a[0, 0], b[0, 0] = 8192, 8192
    a[0, 1], b[0, 2] = 0, 0
    checks.case("mul_rows_fp", f"decompression, {npts} rows",
                lambda: fused.mul_rows(limb.FP, a, b), lambda: fused.mul_rows_ref(limb.FP, a, b),
                limb.FP, npts * 3 * FE_BYTES, npts * OPS_PER_FIELD_MUL, 50, 3)
    return [dict(row, launches=counts[row["name"]]) for row in checks.rows]


def full_list_server(dev, s_per_op_direct: float) -> dict:
    """Phase 8d: the server at 202 bids, then with both list lengths at once.
    Returns the launch counts of the phase."""
    from dusk_blindbidproof_tpu_torch.models import blindbid
    from dusk_blindbidproof_tpu_torch.ops import fused

    client = load_client()
    tmp = socket_dir()
    path = os.path.join(tmp, "bb.sock")
    # as in a fresh daemon: start() builds the 4-bid circuit, a 202-bid
    # request builds its own
    blindbid.blindbid_circuit.cache_clear()
    fused.reset_launch_counts()

    def mixed(i: int) -> dict:
        return full_list_inputs(i) if i % 2 else request_inputs(i)

    try:
        with LiveServer(path, dev) as live:
            latency = []
            with connect(path) as s:
                for i in range(2):
                    t0 = time.perf_counter()
                    client.prove_verify(s, *client.build_prove_body(**full_list_inputs(i)))
                    latency.append(time.perf_counter() - t0)
            flushed = live.take_flushed()
            print(f"server, {FULL_LIST} bids: the first request's prove + verify took "
                  f"{latency[0]:.3f} s (its circuit built inside it), the second "
                  f"{latency[1]:.3f} s; flushed {flushed}", flush=True)
            n, half = FULL_LIST_CLIENTS, FULL_LIST_CLIENTS // 2
            for label, inputs, want in (
                    (f"{n} at {FULL_LIST} bids", full_list_inputs, {FULL_LIST: n}),
                    (f"{half} at 4 bids and {half} at {FULL_LIST} bids", mixed,
                     {4: half, FULL_LIST: half})):
                before = fused.launch_counts()
                wall = clients_at_once(client, path, n, inputs)
                flushed = live.take_flushed()
                after = fused.launch_counts()
                for kind in ("prove", "verify"):
                    got: dict[int, int] = {}
                    for k, size, lens in flushed:
                        if k != kind:
                            continue
                        if len(lens) != 1 or size > MAX_BATCH:
                            fail(f"{label}: a {kind} batch of {size} with list lengths {lens}")
                        got[lens[0]] = got.get(lens[0], 0) + size
                    if got != want:
                        fail(f"{label}: {kind} batches by list length {got}, expected {want}")
                print(f"server: {label} at once all verify: flushed {flushed}, wall {wall:.4f} s, "
                      f"{wall / n} s/op (direct B={FULL_LIST_BATCH} at {FULL_LIST} bids: "
                      f"{s_per_op_direct}); "
                      f"launches { {k: after[k] - before[k] for k in after} }", flush=True)
        if live.server.fault is not None:
            fail(f"the server kept a device fault: {live.server.fault!r}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = fused.launch_counts()
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched behind the server at {FULL_LIST} bids: {missing}")
    return counts


# ---------------------------------------------------------------------------
# Phase 9: BASELINE config 4, 256 independent bids in one batch
# ---------------------------------------------------------------------------


class KernelShapes:
    """Inside the `with` block, every wrapper of ops/fused.py is wrapped:
    for each kernel name, the call on CUDA tensors with the most work is kept
    as (shape, parameters), where parameters are the square flag of K1, k of
    the squaring chain, (windows, steps) of the doubling chain and R of the
    scans."""

    WRAPPERS = ("mul_rows", "sqr_chain", "add", "double", "double_chain", "madd_scan",
                "add_scan", "add_total", "compress")

    def __enter__(self):
        from dusk_blindbidproof_tpu_torch.ops import fused

        self.largest: dict[str, tuple] = {}
        self._fused = fused
        self._saved = {name: getattr(fused, name) for name in self.WRAPPERS}
        keep = self.keep

        def recording(wrapper, fn):
            def call(*args):
                if wrapper == "mul_rows":
                    ctx, a, b = args
                    keep(f"mul_rows_{ctx.name}", a, a is b, a.numel())
                elif wrapper == "sqr_chain":
                    keep("sqr_chain", args[1], args[2], args[1].numel() * args[2])
                elif wrapper == "double_chain":
                    keep("double_chain", args[0], args[1:], args[0].numel() * args[1] * args[2])
                else:  # add, double, compress (no parameter) and the scans (R)
                    keep(wrapper, args[0], args[1] if wrapper in SCAN_ITEM_ROWS else None,
                         args[0].numel())
                return fn(*args)

            return call

        for name, fn in self._saved.items():
            setattr(fused, name, recording(name, fn))
        return self

    def __exit__(self, *exc_info) -> None:
        for name, fn in self._saved.items():
            setattr(self._fused, name, fn)

    def keep(self, name: str, x: torch.Tensor, params, work: int) -> None:
        if x.is_cuda and work > self.largest.get(name, (None, None, 0))[2]:
            self.largest[name] = (tuple(x.shape), params, work)


def config4(dev, mesh_digests: list[str], digests_l4: list[str], counts_l4: dict,
            s_per_op_l4: list[float]):
    """Phase 9: B = CONFIG4_BATCH direct calls.  A proof depends on its own
    request and its own draws alone, and the draws are taken in batch order,
    so the first 16 proofs are phase 4's.  Returns (launch counts of the
    counted round trip, s/op of the timed trips, the kernels' largest calls
    in that round trip from KernelShapes)."""
    from dusk_blindbidproof_tpu_torch.models.blindbid import prove_batch, verify_batch
    from dusk_blindbidproof_tpu_torch.ops import fused
    from dusk_blindbidproof_tpu_torch.utils import profiling

    B = CONFIG4_BATCH
    reqs = requests(B)

    def round_trip():
        proofs = prove_batch(reqs, rng=np.random.default_rng(7), device=dev)
        oks = verify_batch(verify_requests(reqs, proofs), device=dev)
        torch.cuda.synchronize()
        return oks, proofs

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before_gb = torch.cuda.memory_allocated(dev) / 1e9
    t0 = time.perf_counter()
    oks, proofs = round_trip()
    warm = time.perf_counter() - t0
    if oks != [True] * B:
        fail(f"B={B}: the warm-up round trip gave {oks}")
    digests = [proof_digest(p) for p in proofs]
    if digests != mesh_digests:
        wrong = [i for i, (a, b) in enumerate(zip(digests, mesh_digests)) if a != b]
        fail(f"B={B}: the direct proofs differ from phase 6's ranks at places {wrong[:20]}")
    if digests[:len(digests_l4)] != digests_l4:
        fail(f"B={B}: the first {len(digests_l4)} proofs differ from phase 4's")
    vreqs = verify_requests(reqs, proofs)
    vreqs[CONFIG4_BAD].seed += 1
    got = verify_batch(vreqs, device=dev)
    if got != [i != CONFIG4_BAD for i in range(B)]:
        fail(f"B={B}: a wrong seed at place {CONFIG4_BAD} gave "
             f"{[i for i, ok in enumerate(got) if not ok]} rejected")
    del proofs, vreqs
    s_per_op = []
    for _ in range(CONFIG4_TRIPS):
        t0 = time.perf_counter()
        oks, _ = round_trip()
        s_per_op.append((time.perf_counter() - t0) / B)
        if oks != [True] * B:
            fail(f"B={B}: a timed round trip gave {oks}")
    print(f"config 4, B={B}: every proof verifies and equals phase 6's {CONFIG4_MESH_LAYOUT} "
          f"ranks' bytes (the first 16 phase 4's), a wrong seed rejected at place "
          f"{CONFIG4_BAD} only; s/op over "
          f"{CONFIG4_TRIPS} round trips: median {np.median(s_per_op)}, min {min(s_per_op)}, max "
          f"{max(s_per_op)}, all {s_per_op} (warm-up {warm:.3f} s); phase 4 at B=16: median "
          f"{np.median(s_per_op_l4)}, all {s_per_op_l4}", flush=True)

    profiling.enable()
    profiling.reset()
    fused.reset_launch_counts()
    t0 = time.perf_counter()
    with KernelShapes() as shapes, PlainWitnessCalls() as plain:
        oks, _ = round_trip()
    wall = time.perf_counter() - t0
    counts = fused.launch_counts()
    profiling.enable(False)
    if oks != [True] * B:
        fail(f"B={B}: the counted round trip gave {oks}")
    check_witness_launches(counts, plain, f"B={B}")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    print(profiling.report(), flush=True)
    print(f"config 4, B={B}: counted round trip {wall:.4f} s wall; launches {counts}; phase 4 "
          f"at B=16 {counts_l4}; peak device memory {peak_gb:.3f} GB over the phase "
          f"(torch.cuda.max_memory_allocated; {before_gb:.3f} GB allocated before it)", flush=True)
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        fail(f"kernels never launched at B={B}: {missing}")

    print_profile(round_trip, f"config 4, B={B}")
    return counts, s_per_op, shapes.largest


def check_config4_kernels(dev, largest: dict, counts: dict) -> dict:
    """Phase 9b: every kernel at the largest shape the config-4 round trip
    gave it, random limbs in [0, 8192] with an all-8192 unit and an identity
    (or zero) unit at the front, exact against canon(plain) (`sliced_case`).
    Each output unit (a row, a point, a point's windows, a scan block)
    depends on its own inputs alone, so the plain version runs on
    LARGE_SLICE units at each end.  Returns the rows by kernel."""
    from dusk_blindbidproof_tpu_torch.ops import edwards, fused, limb

    gen = torch.Generator(device=dev)
    gen.manual_seed(256)
    nl, S = limb.NLIMBS, LARGE_SLICE
    results = {}

    def ends(n):
        return torch.arange(n, device=dev) if n <= 2 * S else torch.cat(
            [torch.arange(S, device=dev), torch.arange(n - S, n, device=dev)])

    def rand(shape):
        return torch.randint(0, 8193, shape, dtype=torch.int32, device=dev, generator=gen)

    for name in fused.KERNELS:
        if name in WITNESS_KERNELS:
            continue  # phase 2b checks them at B = 256
        if name not in largest:
            fail(f"phase 9's round trip gave {name} no CUDA operands")
        shape, params, _ = largest[name]
        ctx = None if name == "compress" else limb.FL if name == "mul_rows_fl" else limb.FP
        if name.startswith("mul_rows") or name == "sqr_chain":
            a = rand(shape).view(-1, nl)
            a[0], a[1] = 8192, 0
            units, unit = a.shape[0], (nl,)
            if name == "sqr_chain":
                k = params

                def kern():
                    return fused.sqr_chain(ctx, a, k)

                def ref(idx):
                    return fused.sqr_chain_ref(ctx, a[idx], k)

                n_bytes, n_ops, label = units * 2 * FE_BYTES, units * k * OPS_PER_FIELD_SQR, f"k = {k}"
            else:
                b = a if params else rand(a.shape)

                def kern():
                    return fused.mul_rows(ctx, a, b)

                def ref(idx):
                    return fused.mul_rows_ref(ctx, a[idx], b[idx])

                n_bytes = units * (2 if params else 3) * FE_BYTES
                n_ops = units * (OPS_PER_FIELD_SQR if params else OPS_PER_FIELD_MUL)
                label = "square" if params else "product"
            label = f"{label}, {units} rows"
        elif name == "compress":
            pts = compress_points(dev, shape[:-2])  # shape: [B, k, 4, NLIMBS] points
            units = pts.numel() // (4 * nl)
            flat = pts.view(units, 4, nl)
            unit, label = (8,), f"{units} points"

            def kern():
                return fused.compress(pts)

            def ref(idx):
                return fused.compress_ref(flat[idx].cpu()).to(dev)

            n_bytes, n_ops = units * COMPRESS_BYTES, units * COMPRESS_OPS
        elif name in ("add", "double", "double_chain"):
            p = rand(shape).view(-1, 4, nl)
            p[0], p[1] = 8192, edwards.identity(device=dev)
            units, unit, label = p.shape[0], (4, nl), f"{p.shape[0]} points"
            if name == "add":
                q = rand(p.shape)

                def kern():
                    return fused.add(p, q)

                def ref(idx):
                    return fused.add_ref(p[idx], q[idx])

                n_bytes, n_ops = units * POINT_BYTES["add"], units * OPS_PER_ADD
            elif name == "double":
                def kern():
                    return fused.double(p)

                def ref(idx):
                    return fused.double_ref(p[idx])

                n_bytes, n_ops = units * POINT_BYTES["double"], units * OPS_PER_DOUBLE
            else:
                windows, steps = params

                def kern():
                    return fused.double_chain(p, windows, steps)

                def ref(idx):
                    return fused.double_chain_ref(p[idx], windows, steps)

                unit = (windows, 4, nl)
                n_bytes = units * (1 + windows) * 4 * FE_BYTES
                n_ops = units * (windows - 1) * (steps * OPS_PER_DOUBLE_XYZ + OPS_PER_FIELD_MUL)
                label = f"{label} x {windows} windows x {steps} steps"
        else:
            R = params
            x = rand(shape)
            flat = x.view(-1, shape[-3], 4, nl)
            ident = (edwards.identity_niels if name == "madd_scan" else edwards.identity)(device=dev)
            flat[0, 0], flat[0, 1], flat[-1, -1] = 8192, ident, ident
            units = flat.shape[0] * (shape[-3] // R)
            blocks = flat.view(units, R, 4, nl)
            n = units * R

            def kern():
                return getattr(fused, name)(x, R)

            def ref(idx):
                return getattr(fused, name + "_ref")(blocks[idx].reshape(-1, 4, nl), R)

            n_bytes = (n * (SCAN_ITEM_ROWS[name] + (0 if name == "add_total" else 4))
                       + units * 4) * FE_BYTES
            n_ops = n * SCAN_FIELD_MULS[name] * OPS_PER_FIELD_MUL
            label = f"{n} items in {units} blocks of {R}"
        idx = ends(units)

        def pick(got):
            if name == "add_total":
                return got.view(units, 4, nl)[idx]
            if name in SCAN_ITEM_ROWS:
                within, totals = got
                return (within.view(units, R, 4, nl)[idx].reshape(-1, 4, nl),
                        totals.view(units, 4, nl)[idx])
            return got.view(-1, *unit)[idx]

        sliced_case(results, counts, name, f"config 4, {label}", kern,
                    [(pick, lambda: ref(idx))], ctx, n_bytes, n_ops, 3,
                    f"{len(idx)} of {units} units")
        torch.cuda.empty_cache()
    return results


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    try:
        from dusk_blindbidproof_tpu_torch.ops import fused
    except ImportError as exc:
        fail(f"the port's package is not importable here ({exc})")
    started = time.perf_counter()
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
    counts, s_per_op, digests = main_path_b16(dev)
    server_counts = server_in_process(dev, float(np.median(s_per_op)), card)
    server_entry_point(card)
    scripts_on_card()
    mesh_counts, mesh_config4 = mesh_phase(digests, float(np.median(s_per_op)))
    torch.cuda.empty_cache()
    chain_small(dev)
    large_counts = chain_large(dev)
    torch.cuda.empty_cache()
    large = check_large_kernels(dev, large_counts)
    torch.cuda.empty_cache()
    full_list_b1(dev)
    full_counts, full_s_per_op, leaf = full_list_b16(dev, counts, s_per_op)
    full_shapes = check_full_list_kernels(dev, leaf, full_counts)
    del leaf
    full_server_counts = full_list_server(dev, float(np.median(full_s_per_op)))
    torch.cuda.empty_cache()
    config4_counts, config4_s_per_op, largest = config4(dev, mesh_config4, digests, counts,
                                                        s_per_op)
    config4_shapes = check_config4_kernels(dev, largest, config4_counts)

    line = []
    for name, r in kernels.items():
        line.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": counts[name], "launches_server": server_counts[name],
            "launches_mesh": mesh_counts[name], "launches_large": large_counts[name],
            "launches_full_list": full_counts[name],
            "launches_full_list_server": full_server_counts[name],
            "launches_config4": config4_counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "eager_ms": r["eager_ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "large_shapes": large.get(name, []),
            "full_list_shapes": [row for row in full_shapes if row["name"] == name],
            "config4_shapes": config4_shapes.get(name, []),
        })
    print(f"chip_smoke.py: {time.perf_counter() - started:.1f} s; s/op at B=16: median "
          f"{np.median(s_per_op)} over {TIMED_TRIPS} round trips at 4 bids, "
          f"{np.median(full_s_per_op)} at {FULL_LIST} bids; at B={CONFIG4_BATCH} and 4 bids "
          f"{np.median(config4_s_per_op)}")
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
