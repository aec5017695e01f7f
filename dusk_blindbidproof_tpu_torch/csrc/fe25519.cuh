// Field arithmetic mod p = 2^255 - 19 for every mod-p kernel: the point
// kernels (K2 madd, K3 add, K4 double, the bucket scans, the doubling chain)
// and the row kernels (K1 mul_rows mod p, the squaring chain), one element
// per thread.
//
// Replaces the limb planes of the Pallas kernels
// (dusk_blindbidproof_tpu/ops/fused.py, `_build_planes` and, for mod p,
// `_build_scalar_mul`).  K1 mod l runs on sc25519.cuh.
//
// What bounds a point kernel on the H100 is not memory (a point is 336
// bytes) but the integer pipe and the registers: with 21 limbs of 13 bits a
// product was 882 multiply-adds and a point op held ~250 registers, so two
// blocks fit an SM and a 41k-point step ran as two latency-bound waves.
// Here an element is 10 limbs of 26/25 bits (radix 2^25.5, limb i at bit
// ceil(25.5 i)), the form of curve25519-dalek's 32-bit backend:
//
//   product   100 multiply-adds 32 x 32 -> 64 (mad.wide.u32), the wrap
//             2^255 = 19 folded into one operand (9 multiplies by 19) and
//             the doubling of odd x odd terms into the other (5 shifts);
//             each column is carried as soon as it is summed (10 carry
//             steps and the wrap), so one 64-bit sum is live, not ten:
//             about 150 integer instructions, none with a carry flag.
//   square    55 multiply-adds, same carries.
//   element   10 registers; a point 40.
//
// Limb classes (the bounds that make the lazy carries safe):
//   R  "reduced": limb 0 < 2^26, limb 1 < 2^25 + 2^18, limbs 2..9 < 2^26
//      (even) or 2^25 (odd).  fe_load, fe_mul, fe_sqr, fe_carry return R;
//      the value of an R element is < 2^255 + 2^44 < 2 p.
//   fe_add(R, R) has limbs < 2 R, fe_sub(R, R) = a + 2p - b has limbs
//   < 3 R + 2^19 and cannot go negative because every limb of 2p is at least
//   the R bound.  fe_mul and fe_sqr take limbs up to 3 R + 2^19:
//   19 * (3 * 2^26 + 2^19) < 2^32, so the operand scaled by 19 fits a
//   word, and a column of 10 terms plus a carry is below
//   10 * 19 * 9.1 * 2^52 + 2^38 < 2^63.
//   A sum or difference of two non-reduced elements is NOT a valid
//   operand: carry one side first (fe_carry), as pt_madd does for 2 Z.
//
// Memory contract, unchanged (ops/limb.py): [..., 4, 21] int32 rows of
// 13-bit limbs, any limb in [0, 8192] on input (limb 20 included, value up
// to about 2^273), canonical on output (limbs < 2^13, value < p).  fe_load
// carries to strict 13-bit limbs, repacks the bits and folds what lies at
// or above bit 255 with 19; fe_store_canon reduces fully to [0, p) and
// repacks.  Rows of a point are read and written as 16-byte vectors where
// the row's alignment inside its 336-byte point allows (a point is 21
// vectors): fe_load<ROW> / fe_store_canon<ROW>.  A [n, 21] row is 84 bytes
// and aligned to 4 only: the row kernels copy a block's rows through shared
// memory and use the row form, fe_load_row / fe_store_row.
//
// tests/test_torch_field_model.py holds a word-for-word Python model of this
// header against Python integers.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fe25519 {

constexpr int kLimbs = 10;
constexpr int kRowWords = 21;  // 13-bit limbs of one row in memory

__host__ __device__ constexpr int fe_bits(int i) { return (i & 1) ? 25 : 26; }
__host__ __device__ constexpr int fe_off(int i) { return (51 * i + 1) / 2; }  // ceil(25.5 i)
__host__ __device__ constexpr uint32_t fe_mask(int i) { return (1u << fe_bits(i)) - 1u; }
// index of the limb that holds bit `bit`: floor(bit / 25.5)
__host__ __device__ constexpr int fe_limb_of(int bit) { return (2 * bit) / 51; }

struct Fe {
  uint32_t v[kLimbs];
};

// 2 d mod p
__device__ __forceinline__ Fe fe_d2() {
  return Fe{{45281625u, 27714825u, 36363642u, 13898781u, 229458u,
             15978800u, 54557047u, 27058993u, 29715967u, 9444199u}};
}

// limb i of 2 p
__host__ __device__ constexpr uint32_t fe_two_p(int i) {
  return i == 0 ? 0x7FFFFDAu : ((i & 1) ? 0x3FFFFFEu : 0x7FFFFFEu);
}

__device__ __forceinline__ Fe fe_zero() { return Fe{{0, 0, 0, 0, 0, 0, 0, 0, 0, 0}}; }
__device__ __forceinline__ Fe fe_one() { return Fe{{1, 0, 0, 0, 0, 0, 0, 0, 0, 0}}; }

// The 21 words of one row in memory (each in [0, 8192]) -> class R.
__device__ __forceinline__ Fe fe_from_words(const uint32_t* __restrict__ w) {
  // strict 13-bit limbs; `acc` ends as the bit of weight 2^273
  uint32_t s[kRowWords];
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kRowWords; ++j) {
    acc += w[j];
    s[j] = acc & 0x1FFFu;
    acc >>= 13;
  }
  // bits [off_i, off_i + bits_i) come from at most three 13-bit limbs
  Fe x;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int j0 = fe_off(i) / 13, r = fe_off(i) % 13;
    const uint64_t win = (uint64_t)s[j0] | ((uint64_t)s[j0 + 1] << 13) |
                         ((uint64_t)s[j0 + 2] << 26);
    x.v[i] = (uint32_t)(win >> r) & fe_mask(i);
  }
  // bits 255..273: 5 of limb 19, limb 20, the carry; < 2^19
  const uint32_t hi = (s[19] >> 8) | (s[20] << 5) | (acc << 18);
  x.v[0] += 19u * hi;
  x.v[1] += x.v[0] >> 26;
  x.v[0] &= fe_mask(0);
  return x;
}

// Row `ROW` (0..3) of the point at `item` (16-byte aligned) -> class R.
template <int ROW>
__device__ __forceinline__ Fe fe_load(const int4* __restrict__ item) {
  constexpr int w0 = kRowWords * ROW, q0 = w0 / 4, q1 = (w0 + kRowWords - 1) / 4;
  uint32_t w[4 * (q1 - q0 + 1)];
#pragma unroll
  for (int k = q0; k <= q1; ++k) {
    const int4 q = __ldg(item + k);
    w[4 * (k - q0) + 0] = (uint32_t)q.x;
    w[4 * (k - q0) + 1] = (uint32_t)q.y;
    w[4 * (k - q0) + 2] = (uint32_t)q.z;
    w[4 * (k - q0) + 3] = (uint32_t)q.w;
  }
  return fe_from_words(w + (w0 - 4 * q0));
}

// Row form: a [n, 21] row that the block has copied into shared memory (the
// rows of a tile lie 21 words apart, an odd stride, so a warp's 32 reads of
// word j fall into 32 different banks).
__device__ __forceinline__ Fe fe_load_row(const uint32_t* __restrict__ row) {
  return fe_from_words(row);
}

// Limbwise sum; limbs add (R + R < 2 R).
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe x;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) x.v[i] = a.v[i] + b.v[i];
  return x;
}

// a + 2p - b limbwise; b must be class R so that no limb goes negative.
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe x;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) x.v[i] = a.v[i] + fe_two_p(i) - b.v[i];
  return x;
}

// One carry pass in words: any limbs < 2^32 - 2^7 -> class R, same value mod p.
__device__ __forceinline__ Fe fe_carry(const Fe& a) {
  Fe x = a;
#pragma unroll
  for (int i = 0; i < kLimbs - 1; ++i) {
    x.v[i + 1] += x.v[i] >> fe_bits(i);
    x.v[i] &= fe_mask(i);
  }
  x.v[0] += 19u * (x.v[9] >> 25);
  x.v[9] &= fe_mask(9);
  x.v[1] += x.v[0] >> 26;
  x.v[0] &= fe_mask(0);
  return x;
}

// Column k of a product, summed in 64 bits, plus the carry out of column
// k - 1: keeps limb k and passes the rest on.  Columns are finished one at
// a time so that only one sum and one carry are live, not ten sums.
__device__ __forceinline__ void fe_column(Fe& x, int k, uint64_t sum, uint64_t& carry) {
  sum += carry;
  x.v[k] = (uint32_t)sum & fe_mask(k);
  carry = sum >> fe_bits(k);
}

// The carry out of column 9 (< 2^39) wraps to limb 0 times 19 -> class R.
__device__ __forceinline__ void fe_wrap(Fe& x, uint64_t carry) {
  const uint64_t low = (uint64_t)x.v[0] + 19ull * carry;
  x.v[0] = (uint32_t)low & fe_mask(0);
  x.v[1] += (uint32_t)(low >> 26);
}

// a b mod p.  The term a_i b_j lands in column (i + j) mod 10, times 19 if
// i + j >= 10 (folded into b), times 2 if i and j are both odd (folded into a).
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b) {
  uint32_t b19[kLimbs], a2[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    b19[i] = 19u * b.v[i];
    a2[i] = 2u * a.v[i];
  }
  Fe x;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    uint64_t sum = 0;
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
      const int j = (k - i + kLimbs) % kLimbs;
      const uint32_t u = ((i & 1) && (j & 1)) ? a2[i] : a.v[i];
      const uint32_t v = (i > k) ? b19[j] : b.v[j];
      sum += (uint64_t)u * v;
    }
    fe_column(x, k, sum, carry);
  }
  fe_wrap(x, carry);
  return x;
}

// a^2 mod p: the 55 terms i <= j, the off-diagonal ones doubled in a_i.
__device__ __forceinline__ Fe fe_sqr(const Fe& a) {
  uint32_t a19[kLimbs], a2[kLimbs], a4[kLimbs];
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    a19[i] = 19u * a.v[i];
    a2[i] = 2u * a.v[i];
    a4[i] = 4u * a.v[i];
  }
  Fe x;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kLimbs; ++k) {
    uint64_t sum = 0;
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
      const int j = (k - i + kLimbs) % kLimbs;
      if (i > j) continue;
      const bool odd = (i & 1) && (j & 1);
      const uint32_t u = (i == j) ? (odd ? a2[i] : a.v[i]) : (odd ? a4[i] : a2[i]);
      const uint32_t v = (i + j >= kLimbs) ? a19[j] : a.v[j];
      sum += (uint64_t)u * v;
    }
    fe_column(x, k, sum, carry);
  }
  fe_wrap(x, carry);
  return x;
}

// Class R -> the representative in [0, p), strict limbs.
__device__ __forceinline__ Fe fe_canon(const Fe& a) {
  // q = floor((a + 19) / 2^255) is 1 exactly when a >= p (a < 2 p)
  uint32_t q = (a.v[0] + 19u) >> 26;
#pragma unroll
  for (int i = 1; i < kLimbs; ++i) q = (a.v[i] + q) >> fe_bits(i);
  Fe x = a;
  x.v[0] += 19u * q;
#pragma unroll
  for (int i = 0; i < kLimbs - 1; ++i) {
    x.v[i + 1] += x.v[i] >> fe_bits(i);
    x.v[i] &= fe_mask(i);
  }
  x.v[9] &= fe_mask(9);  // drops q 2^255
  return x;
}

// Class R -> the row's 21 canonical limbs of 13 bits.
__device__ __forceinline__ void fe_to_words(const Fe& a, uint32_t* __restrict__ s) {
  const Fe h = fe_canon(a);
#pragma unroll
  for (int j = 0; j < kRowWords - 1; ++j) {
    const int i = fe_limb_of(13 * j), sh = 13 * j - fe_off(i);
    const int up = i + 1 < kLimbs ? i + 1 : i;  // limb 9 has nothing above it
    const uint64_t win =
        (uint64_t)h.v[i] | (i + 1 < kLimbs ? (uint64_t)h.v[up] << fe_bits(i) : 0ull);
    s[j] = (uint32_t)(win >> sh) & 0x1FFFu;
  }
  s[kRowWords - 1] = 0;  // bits 260..272 of a value < 2^255
}

// Canonical row `ROW` of the point at `item` (16-byte aligned): 21 limbs of
// 13 bits, written as single words up to the next 16-byte boundary, then as
// vectors, then the rest as words.
template <int ROW>
__device__ __forceinline__ void fe_store_canon(int32_t* __restrict__ item, const Fe& a) {
  uint32_t s[kRowWords];
  fe_to_words(a, s);
  constexpr int w0 = kRowWords * ROW, head = (4 - w0 % 4) % 4;
  constexpr int nq = (kRowWords - head) / 4, tail = kRowWords - head - 4 * nq;
#pragma unroll
  for (int j = 0; j < head; ++j) item[w0 + j] = (int32_t)s[j];
  int4* vec = reinterpret_cast<int4*>(item + w0 + head);
#pragma unroll
  for (int k = 0; k < nq; ++k)
    vec[k] = make_int4((int)s[head + 4 * k], (int)s[head + 4 * k + 1],
                       (int)s[head + 4 * k + 2], (int)s[head + 4 * k + 3]);
#pragma unroll
  for (int j = 0; j < tail; ++j)
    item[w0 + head + 4 * nq + j] = (int32_t)s[head + 4 * nq + j];
}

// Row form: the canonical row into the block's tile in shared memory.
__device__ __forceinline__ void fe_store_row(uint32_t* __restrict__ row, const Fe& a) {
  fe_to_words(a, row);
}

}  // namespace fe25519
