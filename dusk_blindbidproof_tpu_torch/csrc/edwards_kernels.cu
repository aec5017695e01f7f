// Hand-written Hopper kernels for the BlindBid prover and verifier:
// the modular product of limb rows (K1) and its squaring chain, the Edwards
// point ops in extended coordinates, a = -1 (K3 add, K4 double; K2 madd as
// the leaf of its scan), the 32-step bucket scans built on K2 and K3, and the
// doubling chain built on K4.
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
      (const void*)sqr_chain_kernel};
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

}  // extern "C"
