// Hand-written Hopper kernels for the BlindBid prover and verifier:
// the modular product of limb rows (K1) and its squaring chain, the Edwards
// point ops in extended coordinates, a = -1 (K3 add, K4 double; K2 madd as
// the leaf of its scan), the 32-step bucket scans built on K2 and K3, the
// doubling chain built on K4, the prover's Ristretto compression, and the
// BlindBid witness (its MiMC hashes, then its wires).
//
// Built by ops/fused.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: every entry point takes raw device pointers, an
// item count and the caller's stream, launches one kernel, and returns
// cudaGetLastError().  Nothing here allocates or synchronises.
//
// Replaces (dusk_blindbidproof_tpu/ops/fused.py):
//   K1 bb_mul_rows     <- _build_scalar_mul / mul_rows (FP and FL)
//   K3 bb_point_add    <- _build_planes("add") / add_planes, add_rows
//   K4 bb_point_double <- _build_planes("double") / double_planes, double_rows
//   bb_point_scan      <- the madd (K2, _build_planes("madd")) and add kernels
//                         as lax.scan drives them for 32 steps
//                         (dusk_blindbidproof_tpu/ops/msm.py,
//                         _bucket_scan_planes, _inclusive_scan_points,
//                         _tree_sum_points)
//   bb_double_chain    <- the double kernel as the lax.scan of
//                         prescale_windows drives it, 13 steps a window
//                         (dusk_blindbidproof_tpu/ops/msm.py:57-69)
//   bb_sqr_chain       <- the mod-p product as the fori_loop of _pow2k drives
//                         it (dusk_blindbidproof_tpu/ops/ristretto.py:26-33)
//   bb_compress        <- no TPU kernel: the host's per-point compression
//                         (dusk_blindbidproof_tpu/models/bulletproofs.py:119)
//   bb_mimc_chain,     <- no TPU kernel: the host's BlindBid witness
//   bb_witness_fanout     (dusk_blindbidproof_tpu/models/blindbid.py,
//                         blindbid_witness); see "the BlindBid witness" below
//
// Design: one thread per item (one product, one point op, one block of R
// consecutive items of a scan, or one point or row of a chain); an item's
// limbs are contiguous ([n, 21] or [n, 4, 21] int32), every output is
// canonical.  Everything mod p runs on fe25519.cuh (10 limbs of 26/25 bits,
// 100 multiply-adds a product, 55 a square, a point in 40 registers); K1
// mod l runs on sc25519.cuh (10 limbs of 28 bits, 205 multiply-adds).
//
// What bounds the point kernels: counted as the tensors' bytes (588 to 1008
// bytes a point op) against 3.35 TB/s and 72 wide multiply-adds a product
// against the int32 rate, a point op is bound by its bytes, about 0.012 ms
// for a 41k-point step; in practice a thread's chain of ~1000 dependent
// integer instructions and the number of warps an SM can hold decide the
// time.  What the design does about it: (1) __launch_bounds__(128, 4) holds
// a thread to 128 registers without spills, so four blocks fit an SM and a
// 41k-point step is one wave; (2) rows are read as 16-byte vectors and only
// as they are used, so a point never sits in registers in its 21-limb form,
// and results leave through shared memory as whole coalesced points
// (warp_store_points); (3) the scan kernel keeps the running sum in
// registers in the 10-limb form across all R steps, reads each item once
// (three Niels rows for madd), and writes each prefix canonical straight
// into item order, where the stepwise path launched R kernels that each
// copied a strided operand, re-read the sum and were followed by a stack
// copy of all prefixes; (4) the doubling chain does the same for the window
// tables: a thread doubles its point windows * steps times in registers and
// writes one canonical point a window, and computes T = E H only on the
// steps whose point is stored (doubling reads X, Y, Z alone).  On the main
// path the chain is 656 threads wide, so its time is one thread's latency
// over 247 doublings, far above its bound; it replaces 247 launches.
//
// What bounds the row kernels: K1 moves 252 bytes a product and is bound by
// bytes (0.0025 ms at 32k rows), so it is launch-sized and what matters is
// the memory pattern and the number of launches.  A [n, 21] row is 84 bytes:
// read by its thread it costs a warp 32 sectors a word.  A block therefore
// copies its 128 rows (10752 contiguous bytes) into shared memory with
// consecutive lanes on consecutive 16-byte vectors (tile_load; head and
// tail words singly where the tensor is not 16-byte aligned), each thread
// reads its row at a stride of 21 words, which is odd and so free of bank
// conflicts, and results leave the same way (tile_store).  A product of a
// row with itself takes the square (55 multiply-adds).  The squaring chain
// keeps the element in registers for k squarings: the decompression's
// x^(2^252 - 3) is 9 chains and 13 products instead of 263 launches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "sc25519.cuh"

namespace {

constexpr int kNL = 21;      // int32 words per row: 13-bit limbs
constexpr int kPt = 4 * kNL;  // and per point

// ---- the point kernels ---------------------------------------------------

namespace w = fe25519;

constexpr int kPtVecs = kPt / 4;  // 16-byte vectors per point
// threads a block and blocks an SM of the kernels below: 128 registers a thread
constexpr int kPtThreads = 128;
constexpr int kPtMinBlocks = 4;
constexpr int kMadd = 0, kAdd = 1;         // LEAF
constexpr int kPrefixes = 0, kTotals = 1;  // MODE

struct Pt10 {
  w::Fe x, y, z, t;
};

__device__ __forceinline__ Pt10 pt_identity() {
  return Pt10{w::fe_zero(), w::fe_one(), w::fe_one(), w::fe_zero()};
}

__device__ __forceinline__ Pt10 pt_load(const int4* __restrict__ item) {
  return Pt10{w::fe_load<0>(item), w::fe_load<1>(item), w::fe_load<2>(item),
              w::fe_load<3>(item)};
}

__device__ __forceinline__ void pt_store_canon10(int32_t* __restrict__ item, const Pt10& p) {
  w::fe_store_canon<0>(item, p.x);
  w::fe_store_canon<1>(item, p.y);
  w::fe_store_canon<2>(item, p.z);
  w::fe_store_canon<3>(item, p.t);
}

// X3 = E F, Y3 = G H, Z3 = F G, T3 = E H; e, f may be differences (limbs
// < 3 R) and g, h sums (< 2 R) of reduced elements.
__device__ __forceinline__ Pt10 pt_finish(const w::Fe& a, const w::Fe& b,
                                          const w::Fe& c, const w::Fe& dd) {
  const w::Fe e = w::fe_sub(b, a), f = w::fe_sub(dd, c);
  const w::Fe g = w::fe_add(dd, c), h = w::fe_add(b, a);
  return Pt10{w::fe_mul(e, f), w::fe_mul(g, h), w::fe_mul(f, g), w::fe_mul(e, h)};
}

// P + Q, Q an extended point in memory: add-2008-hwcd-3 (9M), complete for
// a = -1 with d non-square.  Q's rows are loaded as they are used.
__device__ __forceinline__ Pt10 pt_add(const Pt10& p, const int4* __restrict__ q) {
  // T and Z first, so that each of p's coordinates is dead as early as it
  // can be.  2 d goes in last, as the operand whose 19-fold is a
  // compile-time constant: (T1 2d) T2 keeps more words live and spilled.
  const w::Fe c = w::fe_mul(w::fe_mul(p.t, w::fe_load<3>(q)), w::fe_d2());
  const w::Fe dd = w::fe_mul(w::fe_add(p.z, p.z), w::fe_load<2>(q));
  w::Fe qm, qp;
  {
    const w::Fe qx = w::fe_load<0>(q), qy = w::fe_load<1>(q);
    qm = w::fe_sub(qy, qx);
    qp = w::fe_add(qy, qx);
  }
  const w::Fe a = w::fe_mul(w::fe_sub(p.y, p.x), qm);
  const w::Fe b = w::fe_mul(w::fe_add(p.y, p.x), qp);
  return pt_finish(a, b, c, dd);
}

// P + Q, Q affine-Niels rows (y - x, y + x, 2 d x y, unused) in memory:
// madd-2008-hwcd-3 (7M).  2 Z is carried so that D - C stays a valid operand.
__device__ __forceinline__ Pt10 pt_madd(const Pt10& p, const int4* __restrict__ q) {
  const w::Fe a = w::fe_mul(w::fe_sub(p.y, p.x), w::fe_load<0>(q));
  const w::Fe b = w::fe_mul(w::fe_add(p.y, p.x), w::fe_load<1>(q));
  const w::Fe c = w::fe_mul(p.t, w::fe_load<2>(q));
  const w::Fe dd = w::fe_carry(w::fe_add(p.z, p.z));
  return pt_finish(a, b, c, dd);
}

// 2 P: dbl-2008-hwcd with a = -1 (4S + 4M), in the sign convention of the
// plain version (all of E, F, G, H negated, which leaves the products as
// they are).  Reads X, Y, Z only.  With WITH_T false the product T3 = E H is
// left out (t = 0): the next doubling does not read it, so a chain computes
// it only for the points it stores.  Each line names its result's limb
// class (fe25519.cuh): e and f would be < 4 R and < 5 R + 2^19, past what a
// product takes, so both are carried.
template <bool WITH_T>
__device__ __forceinline__ Pt10 pt_double(const Pt10& p) {
  const w::Fe s = w::fe_sqr(w::fe_add(p.x, p.y));                // (X + Y)^2, operand < 2 R: R
  const w::Fe a = w::fe_sqr(p.x), b = w::fe_sqr(p.y);            // R
  const w::Fe h = w::fe_add(a, b);                               // < 2 R
  const w::Fe e = w::fe_carry(w::fe_sub(h, s));                  // h + 2p - s < 4 R -> R
  const w::Fe g = w::fe_sub(a, b);                               // < 3 R + 2^19
  const w::Fe zz = w::fe_sqr(p.z);                               // R
  const w::Fe f = w::fe_carry(w::fe_add(w::fe_add(zz, zz), g));  // 2 Z^2 + g < 5 R + 2^19 -> R
  Pt10 r;
  r.x = w::fe_mul(e, f);
  r.y = w::fe_mul(g, h);
  r.z = w::fe_mul(f, g);
  if constexpr (WITH_T) {
    r.t = w::fe_mul(e, h);
  } else {
    r.t = w::fe_zero();
  }
  return r;
}

template <int LEAF>
__device__ __forceinline__ Pt10 pt_step(const Pt10& p, const int4* __restrict__ q) {
  if constexpr (LEAF == kMadd) {
    return pt_madd(p, q);
  } else {
    return pt_add(p, q);
  }
}

// A warp's 32 result points leave through shared memory.  Lane l writes its
// canonical point into slot l; then the warp copies the slots out with
// consecutive lanes on consecutive 16-byte vectors of one point.  Written
// straight from the registers, every store instruction of a scan touched 32
// half-filled sectors 10752 bytes apart (R = 32), and the prefix writes took
// four fifths of the kernel's time.  `base` is lane 0's destination, `stride`
// the distance between two lanes' points in vectors, `valid` the number of
// lanes that have a point (the warp's ragged tail).
__device__ __forceinline__ void warp_store_points(int4* stage, int lane, const Pt10& p,
                                                  int4* __restrict__ base, int stride,
                                                  int valid) {
  pt_store_canon10(reinterpret_cast<int32_t*>(stage + lane * kPtVecs), p);
  __syncwarp();
#pragma unroll 3
  for (int idx = lane; idx < 32 * kPtVecs; idx += 32) {
    const int l = idx / kPtVecs, v = idx - l * kPtVecs;
    if (l < valid) base[l * stride + v] = stage[idx];
  }
  __syncwarp();
}

// K3 (LEAF = kAdd): out[i] = p[i] + q[i].  Replaces _build_planes("add")
// (pallas_call at ops/fused.py:220) behind fused.add_planes / add_rows.
// K2 (LEAF = kMadd, _build_planes("madd")) is launched only as the leaf of
// point_scan_kernel: every madd of the port is a step of a bucket scan.
template <int LEAF>
__global__ void __launch_bounds__(kPtThreads, kPtMinBlocks)
point_step_kernel(const int4* __restrict__ p, const int4* __restrict__ q,
                  int32_t* __restrict__ out, long long n) {
  __shared__ int4 stage[kPtThreads / 32][32 * kPtVecs];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // n < 2^31, see the entry points
  const int lane = threadIdx.x & 31;
  Pt10 acc = pt_identity();
  if (i < n)
    acc = pt_step<LEAF>(pt_load(p + (long long)i * kPtVecs), q + (long long)i * kPtVecs);
  warp_store_points(stage[threadIdx.x >> 5], lane, acc,
                    reinterpret_cast<int4*>(out) + (long long)(i - lane) * kPtVecs, kPtVecs,
                    (int)min((long long)32, n - (i - lane)));
}

// The bucket scans: thread g owns block g of R consecutive items, starts
// from the identity and adds them in order.  MODE = kPrefixes writes every
// running sum to within[g R + r] and the last to totals[g]; kTotals writes
// only totals[g].  Replaces the lax.scan of R madd / add kernel steps in
// dusk_blindbidproof_tpu/ops/msm.py (_bucket_scan_planes :357 and the
// blocked branches of _inclusive_scan_points and _tree_sum_points).
template <int LEAF, int MODE>
__global__ void __launch_bounds__(kPtThreads, kPtMinBlocks)
point_scan_kernel(const int4* __restrict__ items, int32_t* __restrict__ within,
                  int32_t* __restrict__ totals, long long nblocks, int R) {
  __shared__ int4 stage[kPtThreads / 32][32 * kPtVecs];
  // a thread keeps only g and r beside its running sum: every address is
  // rebuilt from them (the entry point holds nblocks below 2^31)
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int valid = (int)min((long long)32, nblocks - (g - lane));  // the warp's blocks
  int4* const slots = stage[threadIdx.x >> 5];
  Pt10 acc = pt_identity();
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    if (g < nblocks) acc = pt_step<LEAF>(acc, items + ((long long)g * R + r) * kPtVecs);
    if constexpr (MODE == kPrefixes)
      warp_store_points(slots, lane, acc,
                        reinterpret_cast<int4*>(within) + ((long long)(g - lane) * R + r) * kPtVecs,
                        R * kPtVecs, valid);
  }
  warp_store_points(slots, lane, acc,
                    reinterpret_cast<int4*>(totals) + (long long)(g - lane) * kPtVecs, kPtVecs,
                    valid);
}

// K4: out[i] = 2 p[i].  Replaces _build_planes("double") (pallas_call at
// ops/fused.py:220) behind fused.double_planes / double_rows: the Horner
// steps of the bit-plane MSM.
__global__ void __launch_bounds__(kPtThreads, kPtMinBlocks)
point_double_kernel(const int4* __restrict__ p, int32_t* __restrict__ out, long long n) {
  __shared__ int4 stage[kPtThreads / 32][32 * kPtVecs];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // n < 2^31, see the entry points
  const int lane = threadIdx.x & 31;
  Pt10 acc = pt_identity();
  if (i < n) {
    const int4* item = p + (long long)i * kPtVecs;
    acc = pt_double<true>(
        Pt10{w::fe_load<0>(item), w::fe_load<1>(item), w::fe_load<2>(item), w::fe_zero()});
  }
  warp_store_points(stage[threadIdx.x >> 5], lane, acc,
                    reinterpret_cast<int4*>(out) + (long long)(i - lane) * kPtVecs, kPtVecs,
                    (int)min((long long)32, n - (i - lane)));
}

// The doubling chain: out[i, w] = 2^(steps w) p[i] for w < windows, one
// thread a point.  Replaces the lax.scan of 13-double steps in
// dusk_blindbidproof_tpu/ops/msm.py (prescale_windows, :57-69): the window
// tables of the generators and of the verifier's dynamic points.
//
// The thread's point of window `win` leaves through the warp's slots.  Every
// address is rebuilt from the thread's index here, so that the loop below
// keeps nothing live but its three coordinates and two counters.
__device__ __forceinline__ void chain_store(int4* stage, const Pt10& acc,
                                            int32_t* __restrict__ out, long long n,
                                            int windows, int win) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // n windows < 2^31, see the entry point
  const int lane = threadIdx.x & 31;
  warp_store_points(stage + (threadIdx.x >> 5) * 32 * kPtVecs, lane, acc,
                    reinterpret_cast<int4*>(out) + ((long long)(i - lane) * windows + win) * kPtVecs,
                    windows * kPtVecs, (int)min((long long)32, n - (i - lane)));
}

__global__ void __launch_bounds__(kPtThreads, kPtMinBlocks)
double_chain_kernel(const int4* __restrict__ p, int32_t* __restrict__ out, long long n,
                    int windows, int steps) {
  __shared__ int4 stage[kPtThreads / 32 * 32 * kPtVecs];
  Pt10 acc = pt_identity();
  {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) acc = pt_load(p + (long long)i * kPtVecs);
  }
  chain_store(stage, acc, out, n, windows, 0);
  // X, Y, Z alone are carried from doubling to doubling: with T in the loop's
  // state as well the kernel spilled 8 bytes
  w::Fe x = acc.x, y = acc.y, z = acc.z;
#pragma unroll 1
  for (int win = 1; win < windows; ++win) {
#pragma unroll 1
    for (int s = 1; s < steps; ++s) {
      const Pt10 r = pt_double<false>(Pt10{x, y, z, w::fe_zero()});
      x = r.x, y = r.y, z = r.z;
    }
    const Pt10 r = pt_double<true>(Pt10{x, y, z, w::fe_zero()});
    x = r.x, y = r.y, z = r.z;
    chain_store(stage, r, out, n, windows, win);
  }
}

// ---- Ristretto compression ----------------------------------------------------

// u1 = (Z + Y)(Z - Y) and u2 = X Y of the point at `item`.
__device__ __forceinline__ void compress_u(const int4* __restrict__ item, w::Fe& u1, w::Fe& u2) {
  const w::Fe y = w::fe_load<1>(item), z = w::fe_load<2>(item);
  u1 = w::fe_mul(w::fe_add(z, y), w::fe_sub(z, y));
  u2 = w::fe_mul(w::fe_load<0>(item), y);
}

// s of the point at `item`: curve_host.ristretto_compress (dalek's
// RistrettoPoint::compress) step by step, class R.  invsqrt(u1 u2^2) is
// sqrt_ratio_i(1, v) with v = u1 u2^2: r = v^3 (v^7)^((p-5)/8), and
// (v^7)^((p-5)/8) = w^4 v^7 with w = (v^7)^(2^250 - 1).  Only the chain's own
// values are live across its 249 squarings: u1, u2, v, v^3 and v^7 are made
// again from the point's rows after it (with v^7 live across the chain as
// well, the kernel spilled at 128 registers).  sqrt_ratio_i's first test
// (check = u) decides only whether v was a square, which compression does
// not read; its other two tests and its sign test, and compression's three
// sign tests, are made on canonical values.
__device__ __forceinline__ w::Fe ristretto_s(const int4* __restrict__ item) {
  w::Fe w250;
  {
    w::Fe u1, u2;
    compress_u(item, u1, u2);
    const w::Fe v = w::fe_mul(u1, w::fe_sqr(u2));
    const w::Fe v3 = w::fe_mul(w::fe_sqr(v), v);
    w250 = w::fe_pow_250_1(w::fe_mul(w::fe_sqr(v3), v));
  }
  w::Fe u1, u2;
  compress_u(item, u1, u2);
  const w::Fe v = w::fe_mul(u1, w::fe_sqr(u2));
  const w::Fe v3 = w::fe_mul(w::fe_sqr(v), v);
  const w::Fe p58 = w::fe_mul(w::fe_pow2k(w250, 2), w::fe_mul(w::fe_sqr(v3), v));
  w::Fe r = w::fe_mul(v3, p58);  // u v^3 (u v^7)^((p-5)/8), u = 1
  const w::Fe check = w::fe_mul(v, w::fe_sqr(r));
  const w::Fe sqrt_m1 = w::fe_sqrt_m1();
  const bool flipped = w::fe_eq(check, w::fe_neg(w::fe_one()));  // check = -u
  const bool flipped_i = w::fe_eq(check, w::fe_neg(sqrt_m1));     // check = -u sqrt(-1)
  r = w::fe_select(flipped || flipped_i, w::fe_mul(r, sqrt_m1), r);
  const w::Fe inv = w::fe_abs(r);
  const w::Fe den1 = w::fe_mul(inv, u1), den2 = w::fe_mul(inv, u2);
  const w::Fe t = w::fe_load<3>(item);
  const w::Fe z_inv = w::fe_mul(w::fe_mul(den1, den2), t);
  const bool rotate = w::fe_is_neg(w::fe_mul(t, z_inv));
  const w::Fe x0 = w::fe_load<0>(item), y0 = w::fe_load<1>(item);
  const w::Fe x = w::fe_select(rotate, w::fe_mul(y0, sqrt_m1), x0);  // i Y
  w::Fe y = w::fe_select(rotate, w::fe_mul(x0, sqrt_m1), y0);        // i X
  const w::Fe den_inv =
      w::fe_select(rotate, w::fe_mul(den1, w::fe_invsqrt_a_minus_d()), den2);
  y = w::fe_select(w::fe_is_neg(w::fe_mul(x, z_inv)), w::fe_neg(y), y);
  return w::fe_abs(w::fe_mul(den_inv, w::fe_sub(w::fe_load<2>(item), y)));
}

// out[i] = the Ristretto encoding of p[i]: 32 bytes as 8 little-endian words,
// one thread a point.  Replaces no TPU kernel: the JAX package compresses the
// prover's points on the host, in Python integers, one at a time
// (dusk_blindbidproof_tpu/models/bulletproofs.py:119).  It serves the
// prover's four transcript boundaries (the commitments V, A_I1 A_O1 S1, the
// T_i, each IPA round's L and R): one launch on the whole batch's points, and
// only the encodings cross to the host.
//
// What bounds it: the operations, 258 squares and 34 products a point (the
// chain to 2^250 - 1 is 249 squares and 10 products) against 368 bytes (the
// point read, the encoding written).  A point is a chain of several thousand
// dependent integer instructions in one thread, and the prover's calls hold
// 32 to 2048 points, a fraction of one wave: the launch is latency bound
// (about 0.077 ms from 32 to 2048 points on an H100, against a bound of
// 0.0002 to 0.0034 ms), which is accepted, since the host took about 0.2 to
// 0.3 ms a point.  No point is split over lanes: that would shorten a launch
// already this short at the cost of shuffles in every product.
__global__ void __launch_bounds__(kPtThreads, kPtMinBlocks)
ristretto_compress_kernel(const int4* __restrict__ p, int4* __restrict__ out, long long n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // n < 2^31, see the entry point
  if (i >= n) return;
  uint32_t words[8];
  w::fe_to_le_words(ristretto_s(p + (long long)i * kPtVecs), words);
  out[2 * (long long)i] = make_int4((int)words[0], (int)words[1], (int)words[2], (int)words[3]);
  out[2 * (long long)i + 1] =
      make_int4((int)words[4], (int)words[5], (int)words[6], (int)words[7]);
}

// ---- the row kernels --------------------------------------------------------

namespace sc = sc25519;

constexpr int kRowThreads = 128;              // rows a block
constexpr int kRowMinBlocks = 4;              // blocks an SM: 128 registers a thread
constexpr int kTileWords = kRowThreads * kNL;  // 2688 words, a whole number of vectors

// The two moduli of K1 behind one set of names.
struct ModP {
  using Elem = w::Fe;
  static __device__ __forceinline__ Elem load(const uint32_t* row) { return w::fe_load_row(row); }
  static __device__ __forceinline__ Elem mul(const Elem& a, const Elem& b) { return w::fe_mul(a, b); }
  static __device__ __forceinline__ Elem sqr(const Elem& a) { return w::fe_sqr(a); }
  static __device__ __forceinline__ void store(uint32_t* row, const Elem& a) { w::fe_store_row(row, a); }
};
struct ModL {
  using Elem = sc::Sc;
  static __device__ __forceinline__ Elem load(const uint32_t* row) { return sc::sc_load_row(row); }
  static __device__ __forceinline__ Elem mul(const Elem& a, const Elem& b) { return sc::sc_mul(a, b); }
  static __device__ __forceinline__ void store(uint32_t* row, const Elem& a) { sc::sc_store_row(row, a); }
};

// A block's tile of rows between device memory and shared memory.  `g` is
// the tile's first word (aligned to 4 bytes; a [n, 21] tensor promises no
// more), `nwords` its length.  Word k of the tile lies at sh[mis + k], where
// mis = tile_mis(g) is the word's place inside its 16-byte vector in device
// memory: vectors of the two memories then line up, the words before the
// first whole vector and after the last go singly, and consecutive lanes
// copy consecutive vectors.  `sh` is 16-byte aligned and holds kTileWords + 4.
__device__ __forceinline__ int tile_mis(const void* g) {
  return (int)((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
}

__device__ __forceinline__ void tile_load(uint32_t* __restrict__ sh,
                                          const int32_t* __restrict__ g, int nwords) {
  const int mis = tile_mis(g), t = threadIdx.x;
  const int head = (4 - mis) & 3;  // nwords >= 21 > head
  const int nvec = (nwords - head) >> 2;
  const int tail = head + 4 * nvec;  // the first word after the vectors
  if (t < head) sh[mis + t] = (uint32_t)g[t];
  const int4* gv = reinterpret_cast<const int4*>(g + head);
  int4* sv = reinterpret_cast<int4*>(sh + mis + head);
  for (int k = t; k < nvec; k += kRowThreads) sv[k] = __ldg(gv + k);
  if (t < nwords - tail) sh[mis + tail + t] = (uint32_t)g[tail + t];
}

__device__ __forceinline__ void tile_store(int32_t* __restrict__ g,
                                           const uint32_t* __restrict__ sh, int nwords) {
  const int mis = tile_mis(g), t = threadIdx.x;
  const int head = (4 - mis) & 3;
  const int nvec = (nwords - head) >> 2;
  const int tail = head + 4 * nvec;
  if (t < head) g[t] = (int32_t)sh[mis + t];
  int4* gv = reinterpret_cast<int4*>(g + head);
  const int4* sv = reinterpret_cast<const int4*>(sh + mis + head);
  for (int k = t; k < nvec; k += kRowThreads) gv[k] = sv[k];
  if (t < nwords - tail) g[tail + t] = (int32_t)sh[mis + tail + t];
}

// K1: out = a b mod M, M = p (MOD = ModP) or l (ModL); SQR (mod p only, where
// a square is 55 multiply-adds against 100): a and b are one tensor, read
// once.  Replaces _build_scalar_mul (the pallas_call at
// ops/fused.py:328) behind fused.mul_rows; launched for every limb.mul /
// limb.sqr on CUDA tensors.
template <class MOD, bool SQR>
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
mul_rows_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                int32_t* __restrict__ out, int n) {
  __shared__ __align__(16) uint32_t ta[kTileWords + 4];
  __shared__ __align__(16) uint32_t tb[SQR ? 4 : kTileWords + 4];
  const int row0 = blockIdx.x * kRowThreads, t = threadIdx.x;
  const int rows = min(kRowThreads, n - row0);
  const long long w0 = (long long)row0 * kNL;
  tile_load(ta, a + w0, rows * kNL);
  if constexpr (!SQR) tile_load(tb, b + w0, rows * kNL);
  __syncthreads();
  typename MOD::Elem z;
  if (t < rows) {
    const typename MOD::Elem x = MOD::load(ta + tile_mis(a + w0) + t * kNL);
    if constexpr (SQR) {
      z = MOD::sqr(x);
    } else {
      z = MOD::mul(x, MOD::load(tb + tile_mis(b + w0) + t * kNL));
    }
  }
  __syncthreads();  // every row is read: the tile now takes the results
  if (t < rows) MOD::store(ta + tile_mis(out + w0) + t * kNL, z);
  __syncthreads();
  tile_store(out + w0, ta, rows * kNL);
}

// The squaring chain: out = x^(2^k) mod p, the element in registers for all
// k squarings.  Replaces the fori_loop over the mod-p product in
// dusk_blindbidproof_tpu/ops/ristretto.py (_pow2k, :26-33): the runs of
// squarings in x^(2^252 - 3), which the verifier's decompression computes.
__global__ void __launch_bounds__(kRowThreads, kRowMinBlocks)
sqr_chain_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int n, int k) {
  __shared__ __align__(16) uint32_t tile[kTileWords + 4];
  const int row0 = blockIdx.x * kRowThreads, t = threadIdx.x;
  const int rows = min(kRowThreads, n - row0);
  const long long w0 = (long long)row0 * kNL;
  tile_load(tile, x + w0, rows * kNL);
  __syncthreads();
  w::Fe z;
  if (t < rows) {
    z = w::fe_load_row(tile + tile_mis(x + w0) + t * kNL);
#pragma unroll 1
    for (int s = 0; s < k; ++s) z = w::fe_sqr(z);
  }
  __syncthreads();
  if (t < rows) w::fe_store_row(tile + tile_mis(out + w0) + t * kNL, z);
  __syncthreads();
  tile_store(out + w0, tile, rows * kNL);
}

// ---- the BlindBid witness ------------------------------------------------------
//
// Replace no TPU kernel: the JAX package builds the witness on the host, in
// Python integers (dusk_blindbidproof_tpu/models/blindbid.py, blindbid_witness
// and _mimc_witness), and so did the port, which then packed the 3 x (1442 +
// 3 L) values of every proof into bytes for the copy.  Here the witness is
// made on the card from the committed values and the publics, in the gate
// order of models/gadgets.proof_gadget:
//
//   gates [0, 720)            MiMC m = H(k, 0), then x = H(d, m): 90 rounds of
//                             4 gates each, (a, a, a^2) (a^2, a, a^3)
//                             (a^2, a^2, a^4) (a^4, a^3, a^7), a = x + key + c
//   [720, 720 + L)            booleanity (t, 1 - t, t (1 - t)) of each toggle
//   [720 + L, 720 + 3 L)      membership (item, t, item t), (t, x, t x) a bid
//   [720 + 3 L, 1440 + 3 L)   MiMC y = H(seed, x), then z = H(seed, m)
//   1440 + 3 L, 1441 + 3 L    score (y, y_inv, y y_inv), (d, y_inv, d y_inv)
//   [1442 + 3 L, n_pad)       zeros
//
// The work is split in two kernels because its two parts have opposite
// bounds.  The hashes are latency bound: each is 90 dependent rounds of one
// sum and three dependent products, and y waits for x, which waits for m, so
// a proof's critical path is 270 rounds whatever the card's width.  The wires
// are bound by bytes: 3 x n_pad x 84 bytes a proof (132 MB at 256 proofs,
// 0.04 ms at 3.35 TB/s) from 364 scalars a proof.  One kernel that wrote the
// wires from the hash threads would put 363 KB of stores on each of them;
// so `mimc_chain_kernel` runs the hashes with a thread a (proof, hash) and
// writes only each round's a and each hash's output (364 rows a proof), and
// `witness_fanout_kernel` writes every wire entry with a thread a (proof,
// gate), recomputing a round's powers from its a, and coalesced stores.

constexpr int kRounds = 90;                     // models/gadgets.py MIMC_ROUNDS
constexpr int kHashes = 4;                      // m, x, y, z in gate order
constexpr int kHashRows = kHashes * kRounds;    // the rounds' a, hash by hash
constexpr int kScratchRows = kHashRows + kHashes;  // then the four outputs
constexpr int kMimcGates = 4 * kRounds;         // gates of one hash
constexpr int kWitnessThreads = 128;            // gates a block of the fan-out

__device__ __forceinline__ sc::Sc sc_one() {
  sc::Sc one;
#pragma unroll
  for (int j = 0; j < sc::kLimbs; ++j) one.v[j] = j == 0;
  return one;
}

// A row of 13-bit limbs in [0, 8192] as a canonical element: the load
// repacks, the product by one reduces mod l.
__device__ __forceinline__ sc::Sc sc_load_canon(const int32_t* __restrict__ row) {
  return sc::sc_mul(sc::sc_load_row(reinterpret_cast<const uint32_t*>(row)), sc_one());
}

// One hash, models/blindbid._mimc_witness: x = left, then 90 rounds of
// a = x + key + c_r, x = a^7; returns x + key.  Each round's a goes to
// `rounds` (90 rows of 21 limbs).
__device__ __forceinline__ sc::Sc mimc_hash(sc::Sc x, const sc::Sc& key,
                                            const int32_t* __restrict__ consts,
                                            int32_t* __restrict__ rounds) {
#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const sc::Sc a = sc::sc_add(
        sc::sc_add(x, key),
        sc::sc_load_row(reinterpret_cast<const uint32_t*>(consts + r * kNL)));
    sc::sc_store_row(reinterpret_cast<uint32_t*>(rounds + r * kNL), a);
    const sc::Sc a2 = sc::sc_mul(a, a);
    x = sc::sc_mul(sc::sc_mul(a2, a2), sc::sc_mul(a2, a));  // a^4 a^3
  }
  return sc::sc_add(x, key);
}

// The four hashes of 32 proofs a block: warp h runs hash h of proof
// 32 blockIdx.x + lane, h = 0 m = H(k, 0), 1 x = H(d, m), 2 y = H(seed, x),
// 3 z = H(seed, m), in three steps: m; x and z, which wait on m; y, which
// waits on x.  So a block takes 270 rounds.  v [n, m_v, 21] holds (d, k, y,
// y_inv, toggles), pub [n, m_p, 21] (q, z_img, seed, items); scratch
// [n, 364, 21] takes the rounds' a (rows 90 h + r) and the outputs (row
// 360 + h), canonical.  The hash has one call site, so it is compiled once.
__global__ void __launch_bounds__(kHashes * 32, 4)
mimc_chain_kernel(const int32_t* __restrict__ v, int m_v, const int32_t* __restrict__ pub,
                  int m_p, const int32_t* __restrict__ consts, int32_t* __restrict__ scratch,
                  int n) {
  __shared__ sc::Sc keys[2][32];  // m, then x, of the block's proofs
  const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 32 + lane;
  const int step = h == 0 ? 0 : h == 2 ? 2 : 1;
  const int32_t* vr = v + (long long)row * m_v * kNL;
  const int32_t* left = h == 0 ? vr + kNL : h == 1 ? vr : pub + ((long long)row * m_p + 2) * kNL;
  int32_t* out = scratch + (long long)row * kScratchRows * kNL;
#pragma unroll 1
  for (int s = 0; s < 3; ++s) {
    if (s == step && row < n) {
      sc::Sc key;
      if (h == 0) {
#pragma unroll
        for (int j = 0; j < sc::kLimbs; ++j) key.v[j] = 0;
      } else {
        key = keys[h == 2][lane];
      }
      const sc::Sc hash = mimc_hash(sc_load_canon(left), key, consts, out + h * kRounds * kNL);
      if (h < 2) keys[h][lane] = hash;
      sc::sc_store_row(reinterpret_cast<uint32_t*>(out + (kHashRows + h) * kNL), hash);
    }
    __syncthreads();
  }
}

// The wire values (left, right, output) of gate `gate` of one proof; the
// inputs as for mimc_chain_kernel, `rows` the proof's scratch rows.  Every
// gate is a product, so the output is left times right for all of them.
__device__ __forceinline__ void witness_gate(const int32_t* __restrict__ vr,
                                             const int32_t* __restrict__ pr,
                                             const int32_t* __restrict__ rows, int gate,
                                             int list_len, sc::Sc& wl, sc::Sc& wr,
                                             sc::Sc& wo) {
  const int list0 = 2 * kMimcGates, list1 = list0 + 3 * list_len;
  const int score = list1 + 2 * kMimcGates;
#pragma unroll
  for (int j = 0; j < sc::kLimbs; ++j) wl.v[j] = wr.v[j] = wo.v[j] = 0;
  if (gate >= score + 2) return;  // padding
  if (gate < list0 || (gate >= list1 && gate < score)) {
    const int g = gate < list0 ? gate : gate - 3 * list_len;  // hash-major MiMC gate
    const sc::Sc a = sc::sc_load_row(reinterpret_cast<const uint32_t*>(rows + (g >> 2) * kNL));
    const sc::Sc a2 = sc::sc_mul(a, a);
    const sc::Sc a3 = sc::sc_mul(a2, a), a4 = sc::sc_mul(a2, a2);
    switch (g & 3) {
      case 0: wl = a, wr = a; break;
      case 1: wl = a2, wr = a; break;
      case 2: wl = a2, wr = a2; break;
      default: wl = a4, wr = a3; break;
    }
  } else {
    // rows of the two operands: a toggle t, a list item, the hashes' x and y,
    // d and y_inv; values and publics are reduced as they are loaded
    const int32_t *lp, *rp;
    const int k = gate - list0 - list_len;  // membership gate k, bid k / 2
    if (k < 0) {  // booleanity of toggle gate - list0: (t, 1 - t)
      lp = rp = vr + (4 + gate - list0) * kNL;
    } else if (gate < list1) {  // membership: (item, t), then (t, x)
      const int32_t* t = vr + (4 + (k >> 1)) * kNL;
      lp = k & 1 ? t : pr + (3 + (k >> 1)) * kNL;
      rp = k & 1 ? rows + (kHashRows + 1) * kNL : t;
    } else {  // score: (y, y_inv), then (d, y_inv)
      lp = gate == score ? rows + (kHashRows + 2) * kNL : vr;
      rp = vr + 3 * kNL;
    }
    wl = sc_load_canon(lp);
    wr = sc_load_canon(rp);
    if (k < 0) wr = sc::sc_sub(sc_one(), wr);
  }
  wo = sc::sc_mul(wl, wr);
}

// out [3, n, n_pad, 21] (a_L, a_R, a_O), canonical: thread t of block b makes
// gate (128 b + t) mod n_pad of proof (128 b + t) / n_pad.  A block's 128
// consecutive entries of each wire are 10752 contiguous bytes, staged in
// shared memory and stored as whole vectors (tile_store).
__global__ void __launch_bounds__(kWitnessThreads, 4)
witness_fanout_kernel(const int32_t* __restrict__ v, int m_v, const int32_t* __restrict__ pub,
                      int m_p, const int32_t* __restrict__ scratch, int32_t* __restrict__ out,
                      int n, int n_pad, int list_len) {
  __shared__ __align__(16) uint32_t tiles[3][kTileWords + 4];
  const long long total = (long long)n * n_pad, g0 = (long long)blockIdx.x * kWitnessThreads;
  const int count = (int)min((long long)kWitnessThreads, total - g0), t = threadIdx.x;
  if (t < count) {
    const long long idx = g0 + t;
    const int row = (int)(idx / n_pad), gate = (int)(idx - (long long)row * n_pad);
    sc::Sc w[3];
    witness_gate(v + (long long)row * m_v * kNL, pub + (long long)row * m_p * kNL,
                 scratch + (long long)row * kScratchRows * kNL, gate, list_len, w[0], w[1],
                 w[2]);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      sc::sc_store_row(tiles[k] + tile_mis(out + (k * total + g0) * kNL) + t * kNL, w[k]);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 3; ++k) tile_store(out + (k * total + g0) * kNL, tiles[k], count * kNL);
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// launch failure codes of the entry points below that are no cudaError
constexpr int kBadArgument = -1;

}  // namespace

extern "C" {

// Every kernel here stages through shared memory (21 to 43 KB a block): ask
// for the shared-memory split that lets four blocks share an SM.  Once per
// device, before the first launch.
int bb_init() {
  const void* staged[] = {
      (const void*)point_step_kernel<kAdd>,
      (const void*)point_scan_kernel<kMadd, kPrefixes>,
      (const void*)point_scan_kernel<kAdd, kPrefixes>,
      (const void*)point_scan_kernel<kAdd, kTotals>,
      (const void*)point_double_kernel,
      (const void*)double_chain_kernel,
      (const void*)mul_rows_kernel<ModP, false>,
      (const void*)mul_rows_kernel<ModP, true>,
      (const void*)mul_rows_kernel<ModL, false>,
      (const void*)sqr_chain_kernel,
      (const void*)witness_fanout_kernel};
  for (const void* fn : staged) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// mod: 0 for p, 1 for l.  a, b, out: [n, 21], aligned to 4 bytes; mod p,
// a == b takes the square.
int bb_mul_rows(int mod, const int32_t* a, const int32_t* b, int32_t* out, long long n,
                void* stream) {
  if (n < 1 || n >= (1ll << 31) - kRowThreads) return kBadArgument;  // rows are counted in 32 bits
  const unsigned grid = blocks_for(n, kRowThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool sqr = a == b;
  if (mod == 0 && sqr)
    mul_rows_kernel<ModP, true><<<grid, kRowThreads, 0, s>>>(a, b, out, (int)n);
  else if (mod == 0)
    mul_rows_kernel<ModP, false><<<grid, kRowThreads, 0, s>>>(a, b, out, (int)n);
  else if (mod == 1)
    mul_rows_kernel<ModL, false><<<grid, kRowThreads, 0, s>>>(a, b, out, (int)n);
  else
    return kBadArgument;
  return (int)cudaGetLastError();
}

// x, out: [n, 21] mod p; out = x^(2^k), k >= 1.
int bb_sqr_chain(const int32_t* x, int32_t* out, long long n, int k, void* stream) {
  if (n < 1 || k < 1 || n >= (1ll << 31) - kRowThreads) return kBadArgument;
  sqr_chain_kernel<<<blocks_for(n, kRowThreads), kRowThreads, 0, (cudaStream_t)stream>>>(
      x, out, (int)n, k);
  return (int)cudaGetLastError();
}

int bb_point_add(const int32_t* p, const int32_t* q, int32_t* out, long long n,
                 void* stream) {
  if (n >= (1ll << 31) - kPtThreads) return kBadArgument;  // the kernel counts items in 32 bits
  point_step_kernel<kAdd><<<blocks_for(n, kPtThreads), kPtThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)p, (const int4*)q, out, n);
  return (int)cudaGetLastError();
}

// leaf: 0 madd (items are affine-Niels rows), 1 add (extended points);
// mode: 0 prefixes and totals, 1 totals only (`within` may be null).
// items [nblocks R, 4, 21], within the same, totals [nblocks, 4, 21].
int bb_point_scan(int leaf, int mode, const int32_t* items, int32_t* within,
                  int32_t* totals, long long nblocks, int R, void* stream) {
  // the kernel indexes blocks and items within one scan in 32 bits
  if (R < 1 || nblocks >= (1ll << 31) - kPtThreads || (long long)R * kPtVecs >= (1ll << 31) / 32)
    return kBadArgument;
  const unsigned grid = blocks_for(nblocks, kPtThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const int4* it = (const int4*)items;
  if (leaf == kMadd && mode == kPrefixes)
    point_scan_kernel<kMadd, kPrefixes><<<grid, kPtThreads, 0, s>>>(it, within, totals, nblocks, R);
  else if (leaf == kAdd && mode == kPrefixes)
    point_scan_kernel<kAdd, kPrefixes><<<grid, kPtThreads, 0, s>>>(it, within, totals, nblocks, R);
  else if (leaf == kAdd && mode == kTotals)
    point_scan_kernel<kAdd, kTotals><<<grid, kPtThreads, 0, s>>>(it, within, totals, nblocks, R);
  else
    return kBadArgument;
  return (int)cudaGetLastError();
}

int bb_point_double(const int32_t* p, int32_t* out, long long n, void* stream) {
  if (n >= (1ll << 31) - kPtThreads) return kBadArgument;
  point_double_kernel<<<blocks_for(n, kPtThreads), kPtThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)p, out, n);
  return (int)cudaGetLastError();
}

// p [n, 4, 21] -> out [n, windows, 4, 21], out[i, w] = 2^(steps w) p[i].
int bb_double_chain(const int32_t* p, int32_t* out, long long n, int windows, int steps,
                    void* stream) {
  // the kernel counts points, and vectors between two lanes' points, in 32 bits
  if (windows < 1 || steps < 1 || n * windows >= ((1ll << 31) - kPtThreads) / kPtVecs)
    return kBadArgument;
  double_chain_kernel<<<blocks_for(n, kPtThreads), kPtThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)p, out, n, windows, steps);
  return (int)cudaGetLastError();
}

// p [n, 4, 21] -> out [n, 8]: the little-endian words of each point's
// 32-byte Ristretto encoding; both 16-byte aligned.
int bb_compress(const int32_t* p, int32_t* out, long long n, void* stream) {
  if (n >= (1ll << 31) - kPtThreads) return kBadArgument;  // the kernel counts points in 32 bits
  ristretto_compress_kernel<<<blocks_for(n, kPtThreads), kPtThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)p, (int4*)out, n);
  return (int)cudaGetLastError();
}

// v [n, m_v, 21] (d, k, y, y_inv, toggles), pub [n, m_p, 21] (q, z_img, seed,
// items), consts [90, 21] -> scratch [n, 364, 21]: the hashes' round inputs
// and outputs (mimc_chain_kernel).
int bb_mimc_chain(const int32_t* v, int m_v, const int32_t* pub, int m_p, const int32_t* consts,
                  int32_t* scratch, long long n, void* stream) {
  if (n < 1 || n >= (1ll << 31) - 32 || m_v < 5 || m_p < 4) return kBadArgument;
  mimc_chain_kernel<<<blocks_for(n, 32), kHashes * 32, 0, (cudaStream_t)stream>>>(
      v, m_v, pub, m_p, consts, scratch, (int)n);
  return (int)cudaGetLastError();
}

// The same v and pub, and mimc_chain's scratch -> out [3, n, n_pad, 21], the
// wires a_L, a_R, a_O of list_len bids (witness_fanout_kernel).
int bb_witness_fanout(const int32_t* v, int m_v, const int32_t* pub, int m_p,
                      const int32_t* scratch, int32_t* out, long long n, int n_pad, int list_len,
                      void* stream) {
  if (n < 1 || list_len < 1 || m_v != 4 + list_len || m_p != 3 + list_len ||
      n_pad < 4 * kMimcGates + 2 + 3 * list_len ||
      n * n_pad >= (1ll << 31) * (long long)kWitnessThreads)  // blocks are counted in 32 bits
    return kBadArgument;
  witness_fanout_kernel<<<blocks_for(n * n_pad, kWitnessThreads), kWitnessThreads, 0,
                          (cudaStream_t)stream>>>(v, m_v, pub, m_p, scratch, out, (int)n, n_pad,
                                                  list_len);
  return (int)cudaGetLastError();
}

}  // extern "C"
