// Hand-written Hopper kernels for the BlindBid prover and verifier:
// the modular product of limb rows (K1) and the three Edwards point ops
// (K2 madd, K3 add, K4 double) in extended coordinates, a = -1.
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
//
// Design: one thread per item (one product or one point op); an item's
// limbs are contiguous ([n, 21] or [n, 4, 21] int32), every output is
// canonical.
//
// Bound on the card.  A field product is 882 32-bit multiply-adds (441 in
// the schoolbook, 441 in the fold); a point op does 9 (add), 7 (madd) or 8
// (double) of them.  K1 reads two 84-byte rows and writes one; add reads
// two 336-byte points, madd one point and three Niels rows, double X, Y and
// Z, and each writes one point.  Against the H100's 3.35 TB/s and its int32
// multiply-add rate (33.5 T ops/s, half the float32 rate) K1 is bound by
// its bytes and K2-K4 by their multiply-adds; chip_smoke.py computes each
// bound per shape.  The measured times are 10 to 35 times that bound: with
// 80 (K1) to 255 (K3) registers a thread and one thread per item, a scan
// step of ~41k points fills ~10 warps per SM, the strided 84-byte loads do
// not coalesce, and each limb column is a dependent 64-bit multiply-add
// chain, so the kernels wait on latency.
//
// Next: a limb-major coalesced layout (limb j of consecutive items
// adjacent), a wider radix (fewer, 32-bit limbs with a special-form
// reduction for p) to cut the multiply-adds, and fusing the 32-step bucket
// scan into one kernel that keeps its accumulator in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "field25519.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPt = 4 * BB_NL;  // int32 words per point

struct Pt {
  Fe x, y, z, t;
};

__device__ __forceinline__ Pt pt_load(const int32_t* src) {
  Pt p;
  p.x = fe_load(src, 0);
  p.y = fe_load(src + BB_NL, 0);
  p.z = fe_load(src + 2 * BB_NL, 0);
  p.t = fe_load(src + 3 * BB_NL, 0);
  return p;
}

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

// K3: unified add-2008-hwcd-3 (9M), complete for a = -1 with d non-square.
// Replaces _build_planes("add") (pallas_call at ops/fused.py:220) behind
// fused.add_planes / add_rows: block offsets, suffix and tree sums.
__global__ void __launch_bounds__(kThreads)
point_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                 int32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pt P = pt_load(p + i * kPt);
  const Pt Q = pt_load(q + i * kPt);
  Fe d2;
#pragma unroll
  for (int j = 0; j < BB_NL; ++j) d2.v[j] = c_bb_d2[j];
  const Fe a = fe_mul(fe_sub(P.y, P.x, 0), fe_sub(Q.y, Q.x, 0), 0);
  const Fe b = fe_mul(fe_add(P.y, P.x, 0), fe_add(Q.y, Q.x, 0), 0);
  const Fe c = fe_mul(fe_mul(P.t, d2, 0), Q.t, 0);
  const Fe dd = fe_mul(fe_add(P.z, P.z, 0), Q.z, 0);
  const Fe e = fe_sub(b, a, 0), f = fe_sub(dd, c, 0);
  const Fe g = fe_add(dd, c, 0), h = fe_add(b, a, 0);
  pt_store_canon(out + i * kPt, e, f, g, h);
}

// K2: extended + affine-Niels (y - x, y + x, 2 d x y, unused), madd-2008-hwcd-3 (7M).
// Replaces _build_planes("madd") (pallas_call at ops/fused.py:220) behind
// fused.madd_planes / add_rows(niels=True): every fixed-base bucket-scan step.
__global__ void __launch_bounds__(kThreads)
point_madd_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                  int32_t* __restrict__ out, long long n) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Pt P = pt_load(p + i * kPt);
  const int32_t* qi = q + i * kPt;
  const Fe a2 = fe_load(qi, 0), b2 = fe_load(qi + BB_NL, 0),
           c2 = fe_load(qi + 2 * BB_NL, 0);
  const Fe a = fe_mul(fe_sub(P.y, P.x, 0), a2, 0);
  const Fe b = fe_mul(fe_add(P.y, P.x, 0), b2, 0);
  const Fe c = fe_mul(P.t, c2, 0);
  const Fe dd = fe_add(P.z, P.z, 0);
  const Fe e = fe_sub(b, a, 0), f = fe_sub(dd, c, 0);
  const Fe g = fe_add(dd, c, 0), h = fe_add(b, a, 0);
  pt_store_canon(out + i * kPt, e, f, g, h);
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

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// mods: two BbModConst tables as int32 words; d2: 21 limbs of 2 d mod p.
int bb_init_constants(const int32_t* mods, long long nwords, const int32_t* d2) {
  if (nwords * 4 != (long long)sizeof(c_bb_mod)) return -1;
  cudaError_t err = cudaMemcpyToSymbol(c_bb_mod, mods, sizeof(c_bb_mod));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(c_bb_d2, d2, sizeof(c_bb_d2));
}

int bb_mul_rows(int mod, const int32_t* a, const int32_t* b, int32_t* out,
                long long n, void* stream) {
  mul_rows_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(mod, a, b, out, n);
  return (int)cudaGetLastError();
}

int bb_point_add(const int32_t* p, const int32_t* q, int32_t* out, long long n,
                 void* stream) {
  point_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

int bb_point_madd(const int32_t* p, const int32_t* q, int32_t* out, long long n,
                  void* stream) {
  point_madd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

int bb_point_double(const int32_t* p, int32_t* out, long long n, void* stream) {
  point_double_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
