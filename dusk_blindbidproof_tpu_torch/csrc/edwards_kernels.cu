// Hand-written Hopper kernels for the BlindBid prover and verifier:
// the modular product of limb rows (K1), the three Edwards point ops
// (K2 madd, K3 add, K4 double) in extended coordinates, a = -1, and the
// 32-step bucket scans built on K2 and K3.
//
// Built by ops/fused.py:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: every entry point takes raw device pointers, an
// item count and the caller's stream, launches one kernel, and returns
// cudaGetLastError().  Nothing here allocates or synchronises.
//
// Replaces (dusk_blindbidproof_tpu/ops/fused.py):
//   K1 bb_mul_rows     <- _build_scalar_mul / mul_rows (FP and FL)
//   K2 bb_point_madd   <- _build_planes("madd") / madd_planes, add_rows(niels=True)
//   K3 bb_point_add    <- _build_planes("add") / add_planes, add_rows
//   K4 bb_point_double <- _build_planes("double") / double_planes, double_rows
//   bb_point_scan      <- the same madd / add kernels as lax.scan drives them
//                         for 32 steps (dusk_blindbidproof_tpu/ops/msm.py,
//                         _bucket_scan_planes, _inclusive_scan_points,
//                         _tree_sum_points)
//
// Design: one thread per item (one product, one point op, or one block of
// R consecutive items of a scan); an item's limbs are contiguous ([n, 21]
// or [n, 4, 21] int32), every output is canonical.
//
// K1 and K4 run on field25519.cuh: 21 limbs of 13 bits, 882 multiply-adds a
// product, 80 to 200 registers a thread.  They wait on latency at 10 to 12
// times their bounds and are next in line for the core below.
//
// K2, K3 and the scans run on fe25519.cuh (10 limbs of 26/25 bits, 100
// multiply-adds a product, a point in 40 registers).  What bounds them:
// counted as the tensors' bytes (924 / 1008 bytes a point op) against
// 3.35 TB/s and 72 wide multiply-adds a product against the int32 rate, a
// point op is bound by its bytes, about 0.012 ms for a 41k-point step; in
// practice a thread's chain of ~1000 dependent integer instructions and
// the number of warps an SM can hold decide the time.  What the design does
// about it: (1) __launch_bounds__(128, 4) holds a thread to 128 registers
// without spills, so four blocks fit an SM and a 41k-point step is one
// wave; (2) rows are read as 16-byte vectors and only as they are used, so
// a point never sits in registers in its 21-limb form, and results leave
// through shared memory as whole coalesced points (warp_store_points);
// (3) the scan kernel keeps the running sum in registers in the 10-limb
// form across all R steps, reads each item once (three Niels rows for
// madd), and writes each prefix canonical straight into item order, where
// the stepwise path launched R kernels that each copied a strided operand,
// re-read the sum and were followed by a stack copy of all prefixes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fe25519.cuh"
#include "field25519.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPt = 4 * BB_NL;  // int32 words per point

__device__ __forceinline__ void pt_store_canon(int32_t* dst, const Fe& e,
                                               const Fe& f, const Fe& g,
                                               const Fe& h) {
  // X3 = E F, Y3 = G H, Z3 = F G, T3 = E H
  fe_store(dst, fe_canon(fe_mul(e, f, 0), 0));
  fe_store(dst + BB_NL, fe_canon(fe_mul(g, h, 0), 0));
  fe_store(dst + 2 * BB_NL, fe_canon(fe_mul(f, g, 0), 0));
  fe_store(dst + 3 * BB_NL, fe_canon(fe_mul(e, h, 0), 0));
}

// K1: out = a b mod M (M = p for mod == 0, l for mod == 1).
// Replaces _build_scalar_mul (the pallas_call at ops/fused.py:328) behind
// fused.mul_rows; launched for every limb.mul / limb.sqr on CUDA tensors.
__global__ void __launch_bounds__(kThreads)
mul_rows_kernel(int mod, const int32_t* __restrict__ a,
                const int32_t* __restrict__ b, int32_t* __restrict__ out,
                long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fe x = fe_load(a + i * BB_NL, mod);
  const Fe y = fe_load(b + i * BB_NL, mod);
  fe_store(out + i * BB_NL, fe_canon(fe_mul(x, y, mod), mod));
}

// ---- K2, K3 and the scans, on the 10-limb core -------------------------

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

// K2 (LEAF = kMadd) and K3 (LEAF = kAdd): out[i] = p[i] + q[i].
// Replace _build_planes("madd") / _build_planes("add") (pallas_call at
// ops/fused.py:220) behind fused.madd_planes / add_planes / add_rows.
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

// K4: dbl-2008-hwcd, a = -1 (4M + 4S).
// Replaces _build_planes("double") (pallas_call at ops/fused.py:220) behind
// fused.double_planes / double_rows: window tables and Horner steps.
__global__ void __launch_bounds__(kThreads)
point_double_kernel(const int32_t* __restrict__ p, int32_t* __restrict__ out,
                    long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int32_t* pi = p + i * kPt;
  const Fe x1 = fe_load(pi, 0), y1 = fe_load(pi + BB_NL, 0),
           z1 = fe_load(pi + 2 * BB_NL, 0);
  const Fe a = fe_sqr(x1, 0), b = fe_sqr(y1, 0), zz = fe_sqr(z1, 0);
  const Fe c = fe_add(zz, zz, 0);
  const Fe h = fe_add(a, b, 0);
  const Fe e = fe_sub(h, fe_sqr(fe_add(x1, y1, 0), 0), 0);
  const Fe g = fe_sub(a, b, 0);
  const Fe f = fe_add(c, g, 0);
  pt_store_canon(out + i * kPt, e, f, g, h);
}

inline unsigned blocks_for(long long n, int threads = kThreads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

// mods: two BbModConst tables as int32 words (K1 and K4; the point kernels on
// fe25519.cuh carry their constants in the code).
int bb_init_constants(const int32_t* mods, long long nwords) {
  if (nwords * 4 != (long long)sizeof(c_bb_mod)) return -1;
  cudaError_t err = cudaMemcpyToSymbol(c_bb_mod, mods, sizeof(c_bb_mod));
  if (err != cudaSuccess) return (int)err;
  // the point kernels stage 42 KB a block: ask for the shared-memory split
  // that lets kPtMinBlocks blocks share an SM
  const void* staged[] = {
      (const void*)point_step_kernel<kMadd>, (const void*)point_step_kernel<kAdd>,
      (const void*)point_scan_kernel<kMadd, kPrefixes>,
      (const void*)point_scan_kernel<kAdd, kPrefixes>,
      (const void*)point_scan_kernel<kAdd, kTotals>};
  for (const void* fn : staged) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

int bb_mul_rows(int mod, const int32_t* a, const int32_t* b, int32_t* out,
                long long n, void* stream) {
  mul_rows_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(mod, a, b, out, n);
  return (int)cudaGetLastError();
}

int bb_point_add(const int32_t* p, const int32_t* q, int32_t* out, long long n,
                 void* stream) {
  if (n >= (1ll << 31) - kPtThreads) return -1;  // the kernel counts items in 32 bits
  point_step_kernel<kAdd><<<blocks_for(n, kPtThreads), kPtThreads, 0, (cudaStream_t)stream>>>(
      (const int4*)p, (const int4*)q, out, n);
  return (int)cudaGetLastError();
}

int bb_point_madd(const int32_t* p, const int32_t* q, int32_t* out, long long n,
                  void* stream) {
  if (n >= (1ll << 31) - kPtThreads) return -1;  // the kernel counts items in 32 bits
  point_step_kernel<kMadd><<<blocks_for(n, kPtThreads), kPtThreads, 0, (cudaStream_t)stream>>>(
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
    return -1;
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
    return -1;
  return (int)cudaGetLastError();
}

int bb_point_double(const int32_t* p, int32_t* out, long long n, void* stream) {
  point_double_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
