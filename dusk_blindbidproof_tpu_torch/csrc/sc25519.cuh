// Scalar arithmetic mod l = 2^252 + 27742317777372353535851937790883648493
// (the order of the Ristretto group) for K1 mul_rows mod l, one product per
// thread.
//
// Replaces, for that modulus, `_build_scalar_mul`
// (dusk_blindbidproof_tpu/ops/fused.py:328).
//
// l has no special form, so the wrap of fe25519.cuh (2^255 = 19) has no
// counterpart.  Of the two designs that serve, folding with precomputed
// residues and Barrett, this header folds: Barrett needs two more
// half-products by 10-limb constants (about 130 multiply-adds) and a
// correction loop, the fold 100 multiply-adds by constants and none, because
// l sits just above a limb boundary:
//
//   element   ten limbs of 28 bits, value = sum v[i] 2^(28 i) < 2^280; limb 9
//             starts at bit 252 = 28 * 9, the bit of l's leading one.
//   product   100 multiply-adds 32 x 32 -> 64 into 19 columns, each below
//             10 * 2^56 < 2^60, carried as it is summed into 20 limbs.
//   fold 1    limbs 10..19 times the rows 2^(28 (10 + k)) mod l (sc_fold,
//             from Python integers): 100 multiply-adds, columns below
//             2^28 + 10 * 2^56; the value falls below 2^285.
//   fold 2    split at 2^252: x = lo + hi 2^252 with hi < 2^33, and
//             2^252 = -D mod l, D = l - 2^252 < 2^125: lo - hi D lies in
//             (-2^158, 2^252), so adding l once where it is negative gives
//             the representative in [0, l): 5 multiply-adds, no loop.
//
// Memory contract, as for mod p (ops/limb.py): [..., 21] int32 rows of 13-bit
// limbs, any limb in [0, 8192] on input (limb 20 included, value below
// 2^274), canonical on output (limbs < 2^13, value < l).
//
// tests/test_torch_scalar_model.py holds a word-for-word Python model of this
// header against Python integers; it reads the constants below out of this
// file.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sc25519 {

constexpr int kLimbs = 10;
constexpr int kRowWords = 21;  // 13-bit limbs of one row in memory
constexpr int kBits = 28;
constexpr uint32_t kMask = (1u << kBits) - 1u;
constexpr int kDLimbs = 5;

struct Sc {
  uint32_t v[kLimbs];
};

// limbs of D = l - 2^252
__constant__ uint32_t sc_d[kDLimbs] = {217437165u, 19280293u, 127719000u, 262007343u, 5342u};

// sc_fold[k][j]: limb j of 2^(28 (10 + k)) mod l
__constant__ uint32_t sc_fold[kLimbs][kLimbs] = {
    {217437165u, 70278584u, 108438706u, 134288343u, 6433455u, 268430113u, 268435455u, 268435455u, 268435455u, 0u},
    {217437165u, 19280293u, 178717291u, 242727049u, 140721798u, 6428112u, 268430113u, 268435455u, 268435455u, 0u},
    {217437165u, 19280293u, 127719000u, 44570178u, 249160505u, 140716455u, 6428112u, 268430113u, 268435455u, 0u},
    {217437165u, 19280293u, 127719000u, 262007343u, 51003633u, 249155162u, 140716455u, 6428112u, 268430113u, 0u},
    {246554483u, 203830178u, 39688231u, 14333151u, 28547521u, 50998291u, 249155162u, 140716455u, 6428112u, 0u},
    {220683888u, 203279621u, 23840929u, 128764918u, 28823034u, 28547393u, 50998291u, 249155162u, 140716455u, 0u},
    {707429u, 229593610u, 30910841u, 180085645u, 171827787u, 28820233u, 28547393u, 50998291u, 249155162u, 0u},
    {119916718u, 96864963u, 174593749u, 117024285u, 121447798u, 171822828u, 28820233u, 28547393u, 50998291u, 0u},
    {185764201u, 249522266u, 144907746u, 153575977u, 96364547u, 121446783u, 171822828u, 28820233u, 28547393u, 0u},
    {238390227u, 267680238u, 206248602u, 32002053u, 96877799u, 96363979u, 121446783u, 171822828u, 28820233u, 0u},
};

// The 21 words of one row (each in [0, 8192]) -> strict 28-bit limbs, limb 9
// below 2^22.  `row` is the thread's row in the block's tile in shared memory.
__device__ __forceinline__ Sc sc_load_row(const uint32_t* __restrict__ row) {
  // strict 13-bit limbs; s[21] is the carry, the bit of weight 2^273
  uint32_t s[kRowWords + 3];
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kRowWords; ++j) {
    acc += row[j];
    s[j] = acc & 0x1FFFu;
    acc >>= 13;
  }
  s[kRowWords] = acc;
  s[kRowWords + 1] = 0;
  s[kRowWords + 2] = 0;
  // bits [28 i, 28 i + 28) come from at most four 13-bit limbs
  Sc x;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) {
    const int j0 = (kBits * i) / 13, r = (kBits * i) % 13;
    const uint64_t win = (uint64_t)s[j0] | ((uint64_t)s[j0 + 1] << 13) |
                         ((uint64_t)s[j0 + 2] << 26) | ((uint64_t)s[j0 + 3] << 39);
    x.v[i] = (uint32_t)(win >> r) & kMask;
  }
  return x;
}

// a b mod l, canonical: value in [0, l), limbs strict (limb 9 is 0 or 1).
__device__ __forceinline__ Sc sc_mul(const Sc& a, const Sc& b) {
  // the product as 20 strict limbs; limb 19 is the last carry
  uint32_t r[2 * kLimbs];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 2 * kLimbs - 1; ++k) {
    uint64_t sum = carry;
#pragma unroll
    for (int i = 0; i < kLimbs; ++i) {
      const int j = k - i;
      if (j < 0 || j >= kLimbs) continue;
      sum += (uint64_t)a.v[i] * b.v[j];
    }
    r[k] = (uint32_t)sum & kMask;
    carry = sum >> kBits;
  }
  r[2 * kLimbs - 1] = (uint32_t)carry;
  // fold 1: limbs 10..19 through the residue rows
  uint32_t x[kLimbs];
  carry = 0;
#pragma unroll
  for (int j = 0; j < kLimbs; ++j) {
    uint64_t sum = carry + r[j];
#pragma unroll
    for (int k = 0; k < kLimbs; ++k) sum += (uint64_t)r[kLimbs + k] * sc_fold[k][j];
    x[j] = (uint32_t)sum & kMask;
    carry = sum >> kBits;
  }
  // fold 2: what lies at or above bit 252 (limb 9 and the carry), times -D
  const uint64_t hi = (carry << kBits) | x[kLimbs - 1];  // < 2^33
  Sc y;
  int64_t acc = 0;
#pragma unroll
  for (int j = 0; j < kLimbs - 1; ++j) {
    acc += (int64_t)x[j];
    if (j < kDLimbs) acc -= (int64_t)(hi * sc_d[j]);
    y.v[j] = (uint32_t)acc & kMask;
    acc >>= kBits;  // arithmetic shift: floor division by 2^28
  }
  // acc is 0, or -1 where lo - hi D went negative: then add l = 2^252 + D,
  // whose 2^252 cancels the borrow
  const uint32_t neg = (uint32_t)acc;
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < kLimbs - 1; ++j) {
    const uint32_t t = y.v[j] + (j < kDLimbs ? (sc_d[j] & neg) : 0u) + c;
    y.v[j] = t & kMask;
    c = t >> kBits;
  }
  y.v[kLimbs - 1] = c;
  return y;
}

// A canonical element -> its row of 21 limbs of 13 bits in the block's tile.
__device__ __forceinline__ void sc_store_row(uint32_t* __restrict__ row, const Sc& a) {
#pragma unroll
  for (int j = 0; j < kRowWords; ++j) {
    const int i = (13 * j) / kBits, sh = 13 * j - kBits * i;
    const int up = i + 1 < kLimbs ? i + 1 : i;  // limb 9 has nothing above it
    const uint64_t win =
        (uint64_t)a.v[i] | (i + 1 < kLimbs ? (uint64_t)a.v[up] << kBits : 0ull);
    row[j] = (uint32_t)(win >> sh) & 0x1FFFu;
  }
}

}  // namespace sc25519
