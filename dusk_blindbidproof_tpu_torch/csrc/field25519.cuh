// Field arithmetic mod p = 2^255 - 19 and mod l (the Ristretto group order)
// on 21 limbs of 13 bits, one element per thread.
//
// Layout and contract (shared with ops/limb.py):
//   element = sum_j limb[j] * 2^(13 j), 21 int32 limbs.
//   Kernel inputs: every limb in [0, 8192], limb 20 included (values up to
//   about 2^273).  Kernel outputs: canonical, limbs < 2^13 and value < M.
//
// Inside a kernel an element is kept "strict": 21 limbs each < 2^13, so
// value < 2^273, not necessarily < M.  Products accumulate column by column
// in one 64-bit register (each column is at most 21 * 8191^2 < 2^31, so
// the running carry never nears 2^64), and reduction folds the limbs above
// limb 20 with the rows 2^(13 (21 + k)) mod M that ModContext builds on the
// host; the rows and the other per-modulus tables live in __constant__
// memory, uploaded once by bb_init_constants.
#pragma once

#include <stdint.h>

#define BB_NL 21
#define BB_BITS 13
#define BB_MASK 0x1FFFu

// Mirrors the int32 table that ops/fused.py packs; all members are 4-byte
// words, so the struct has no padding.
struct BbModConst {
  uint32_t fold[BB_NL][BB_NL];  // fold[k][j]: limb j of 2^(13 (21 + k)) mod M
  uint32_t mod[BB_NL];          // limbs of M
  uint32_t canon_row[BB_NL];    // 2^split mod M, or M - (2^split mod M) if canon_neg
  uint32_t sub_bias[BB_NL + 1]; // limbs of K M, the least multiple of M >= 2^273
  int32_t split_limb;           // split bit = 13 split_limb + split_off
  int32_t split_off;
  int32_t canon_neg;
};

__constant__ BbModConst c_bb_mod[2];  // [0] = mod p, [1] = mod l
__constant__ uint32_t c_bb_d2[BB_NL]; // 2 d mod p

struct Fe {
  uint32_t v[BB_NL];
};

// Fold a carry h out of limb 20 back in with 2^273 mod M until none is
// left.  h < 2^19 on entry; at most three rounds are ever needed.
__device__ __forceinline__ void fe_fold_carry(Fe& x, uint64_t h, int m) {
  const BbModConst& c = c_bb_mod[m];
#pragma unroll 1
  for (int it = 0; it < 4 && h; ++it) {
    const uint32_t hh = (uint32_t)h;
    uint64_t acc = 0;
#pragma unroll
    for (int j = 0; j < BB_NL; ++j) {
      acc += (uint64_t)x.v[j] + (uint64_t)hh * c.fold[0][j];
      x.v[j] = (uint32_t)acc & BB_MASK;
      acc >>= BB_BITS;
    }
    h = acc;
  }
}

// Kernel input (limbs <= 8192) -> strict.
__device__ __forceinline__ Fe fe_load(const int32_t* src, int m) {
  Fe x;
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < BB_NL; ++j) {
    acc += (uint32_t)src[j];
    x.v[j] = (uint32_t)acc & BB_MASK;
    acc >>= BB_BITS;
  }
  fe_fold_carry(x, acc, m);
  return x;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, int m) {
  Fe x;
  uint64_t acc = 0;
#pragma unroll
  for (int j = 0; j < BB_NL; ++j) {
    acc += (uint64_t)a.v[j] + b.v[j];
    x.v[j] = (uint32_t)acc & BB_MASK;
    acc >>= BB_BITS;
  }
  fe_fold_carry(x, acc, m);
  return x;
}

// a - b + K M: nonnegative because K M >= 2^273 > b.
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, int m) {
  const BbModConst& c = c_bb_mod[m];
  Fe x;
  int64_t acc = 0;
#pragma unroll
  for (int j = 0; j < BB_NL; ++j) {
    acc += (int64_t)a.v[j] - (int64_t)b.v[j] + c.sub_bias[j];
    x.v[j] = (uint32_t)(acc & BB_MASK);
    acc >>= BB_BITS;  // arithmetic shift: floor division by 2^13
  }
  acc += c.sub_bias[BB_NL];
  fe_fold_carry(x, (uint64_t)acc, m);
  return x;
}

// Product-scanning schoolbook (441 multiply-adds) into 42 strict limbs,
// then one fold of limbs 21..41 through the residue rows.
__device__ __forceinline__ Fe fe_mul(const Fe& a, const Fe& b, int m) {
  const BbModConst& c = c_bb_mod[m];
  uint32_t r[2 * BB_NL];
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < 2 * BB_NL - 1; ++k) {
#pragma unroll
    for (int i = (k < BB_NL ? 0 : k - BB_NL + 1); i <= (k < BB_NL ? k : BB_NL - 1); ++i)
      acc += (uint64_t)a.v[i] * b.v[k - i];
    r[k] = (uint32_t)acc & BB_MASK;
    acc >>= BB_BITS;
  }
  r[2 * BB_NL - 1] = (uint32_t)acc;  // < 2^13: the product is < 2^546
  Fe x;
  acc = 0;
#pragma unroll
  for (int j = 0; j < BB_NL; ++j) {
    acc += r[j];
#pragma unroll
    for (int k = 0; k < BB_NL; ++k) acc += (uint64_t)r[BB_NL + k] * c.fold[k][j];
    x.v[j] = (uint32_t)acc & BB_MASK;
    acc >>= BB_BITS;
  }
  fe_fold_carry(x, acc, m);
  return x;
}

__device__ __forceinline__ Fe fe_sqr(const Fe& a, int m) { return fe_mul(a, a, m); }

// Strict -> canonical [0, M).  Split value = lo + hi 2^split; fold hi with
// +R (p: R = 19) or -D (l: D = l - 2^252) in signed limbs, add M back if
// the result went negative, then subtract M while it is >= M.
__device__ __forceinline__ Fe fe_canon(const Fe& a, int m) {
  const BbModConst& c = c_bb_mod[m];
  const int sl = c.split_limb, so = c.split_off;
  int64_t hi = 0;
  // only limbs sl and sl + 1 (= 20) lie above the split bit
  hi = (int64_t)(a.v[sl] >> so) + ((int64_t)a.v[BB_NL - 1] << (BB_BITS - so));
  if (c.canon_neg) hi = -hi;
  Fe x;
  int64_t acc = 0;
#pragma unroll
  for (int j = 0; j < BB_NL; ++j) {
    int64_t lo = j < sl ? (int64_t)a.v[j] : (j == sl ? (int64_t)(a.v[j] & ((1u << so) - 1)) : 0);
    acc += lo + hi * (int64_t)c.canon_row[j];
    x.v[j] = (uint32_t)(acc & BB_MASK);
    acc >>= BB_BITS;
  }
  if (acc < 0) {  // value = x - 2^273 in (-M, 0): add M, drop the wrap
    uint64_t s = 0;
#pragma unroll
    for (int j = 0; j < BB_NL; ++j) {
      s += (uint64_t)x.v[j] + c.mod[j];
      x.v[j] = (uint32_t)s & BB_MASK;
      s >>= BB_BITS;
    }
  }
#pragma unroll 1
  for (int it = 0; it < 2; ++it) {
    Fe d;
    int64_t br = 0;
#pragma unroll
    for (int j = 0; j < BB_NL; ++j) {
      br += (int64_t)x.v[j] - (int64_t)c.mod[j];
      d.v[j] = (uint32_t)(br & BB_MASK);
      br >>= BB_BITS;
    }
    if (br < 0) break;  // x < M
    x = d;
  }
  return x;
}

__device__ __forceinline__ void fe_store(int32_t* dst, const Fe& x) {
#pragma unroll
  for (int j = 0; j < BB_NL; ++j) dst[j] = (int32_t)x.v[j];
}
