// K0: the composite Carter-Wegman cell index, and K0s: the packed
// signed-mode sign bits beside it, as one __device__ helper that computes
// both in one pass (index_and_sign_bits, at the end of this file).
//
// K0 replaces src/repro/kernels/hashes.py `row_indices` (inlined in every
// Pallas kernel body there).  One row's cell index of one key is
//
//     sum_j ((r_j + sum_{c in group j} q_c * x_c) mod P31) mod range_j * stride_j
//
// The reference evaluates it in uint32 limbs with a mod after every step,
// because a TPU has no 64-bit lanes.  Here each term q_c * x_c < 2^47 and up
// to 64 of them sum below 2^53, so a uint64 sum with ONE reduction at the end
// is exact (the semantics of core/hashing.py `cw_hash_np`); the two forms are
// equal mod P31, hence bit-identical.  The reduction is a Mersenne fold, not
// a 64-bit division, and `% range_j` a multiply and a shift, because the
// folded value is below 2^31.
//
// K0s replaces src/repro/kernels/hashes.py `row_sign_bits` and
// `signs_from_bits` (inlined in the signed Pallas kernels).  One CW pass per
// group under the sign params; bit j of the result is the XOR of the hash
// parities of groups 0..j, i.e. the sign of the level-j prefix (1 = -1).  The
// parity is taken of the canonical residue in [0, P31) -- the low bit of an
// unreduced 64-bit sum would be another bit.
//
// The plan is a small struct passed by value as a __grid_constant__ kernel
// parameter: nothing about the spec is specialised at compile time.  Every
// kernel that hashes a key (K1-K3, K5-K8, K7m and the float32 folds) calls
// index_and_sign_bits.
#pragma once

#include <cstdint>

#define SK_MAX_CHUNKS 64
#define SK_MAX_GROUPS 16
#define SK_MAX_LEVELS 16

// Mirrored field for field by repro_torch/kernels/_cuda.py (ctypes).
struct IndexPlanC {
  int32_t n_groups;
  int32_t total_chunks;
  int32_t group_start[SK_MAX_GROUPS + 1];  // group j's columns: cols[group_start[j] .. group_start[j+1])
  int32_t cols[SK_MAX_CHUNKS];             // chunk columns, group-major
  uint32_t ranges[SK_MAX_GROUPS];
  uint32_t strides[SK_MAX_GROUPS];
};

// Level l of the concatenated hierarchy table: columns offsets[l] + idx / divs[l].
struct LevelsC {
  int32_t n_levels;
  uint32_t divs[SK_MAX_LEVELS];
  int64_t offsets[SK_MAX_LEVELS];
};

// v or -v as the sign bit says, in two's complement (no signed overflow).
__device__ __forceinline__ int32_t sk_apply_sign(int32_t v, uint32_t negative) {
  return negative ? (int32_t)(0u - (uint32_t)v) : v;
}

// The float32 form: the reference multiplies by s = +-1 in float32, which
// is an exact negation.
__device__ __forceinline__ float sk_apply_sign(float v, uint32_t negative) {
  return negative ? -v : v;
}

// Division by an invariant d of a numerator below 2^31 as a multiply and a
// shift (Granlund and Montgomery, 1994, Thm 4.2): with s = 31 + ceil(log2 d)
// and m = ceil(2^s / d), n / d = (n * m) >> s for every n < 2^31, and
// m < 2^32.  The launchers make one per hash range (and per level divisor).
struct DivisorC {
  uint32_t m, s;
};

inline DivisorC make_divisor(uint32_t d) {
  uint32_t l = 0;
  while ((1ull << l) < d) ++l;
  const uint64_t s = 31 + l;
  return {(uint32_t)(((1ull << s) + d - 1) / d), (uint32_t)s};
}

__device__ __forceinline__ uint32_t div_by(const DivisorC& v, uint32_t n) {
  return (uint32_t)(((uint64_t)n * v.m) >> v.s);
}

// One divisor per group range of a plan, passed as a __grid_constant__.
struct HashDivsC {
  DivisorC range[SK_MAX_GROUPS];
};

inline HashDivsC make_hash_divs(const IndexPlanC& plan) {
  HashDivsC divs{};
  for (int j = 0; j < plan.n_groups; ++j) divs.range[j] = make_divisor(plan.ranges[j]);
  return divs;
}

// x mod P31 in [0, P31) for x < 2^53: two Mersenne folds, the second in 32
// bits, since (x >> 31) + (x & P31) is below 2^32.
__device__ __forceinline__ uint32_t mod_p31_53(uint64_t x) {
  const uint32_t P = 0x7FFFFFFFu;
  uint32_t y = (uint32_t)(x >> 31) + ((uint32_t)x & P);
  y = (y >> 31) + (y & P);
  return y >= P ? y - P : y;
}

// The low 32 bits of an int64 entry: every hash param is below P31 and every
// chunk below 2^16.
__device__ __forceinline__ uint32_t lo32(const int64_t* __restrict__ p, int i) {
  return __ldg(reinterpret_cast<const uint32_t*>(p + i));
}

// Keys of at most kRegChunks chunks, in groups of one chunk or more, hold
// them in registers (kChunks = kRegChunks below); others read them from the
// chunk array for each row (kChunks = 0).  The launchers pick the instance.
constexpr int kRegChunks = 8;

inline bool chunks_in_registers(const IndexPlanC& plan) {
  bool fits = plan.total_chunks <= kRegChunks;
  for (int j = 0; j < plan.n_groups; ++j) fits &= plan.group_start[j + 1] > plan.group_start[j];
  return fits;
}

// K0's cell index of one row of the key, and when kSigned K0s's sign bits
// beside it, in one pass over the key's chunks (x[c] at the chunk column c;
// q, r the row's bucket params, sq, sr its sign params): each product is
// one 32 x 32 -> 64-bit multiply, the sums stay below 2^53, and `% range`
// is div_by's multiply and shift.  Unsigned, sq and sr are never
// read and `bits` stays 0.  kChunks > 0: chunk t (group-major order) is
// xr[t], and every group has a chunk, so group j ends at chunk
// group_start[j+1] - 1.
template <int kChunks, bool kSigned>
__device__ __forceinline__ void index_and_sign_bits(
    const IndexPlanC& plan, const HashDivsC& divs, const uint32_t* xr,
    const int64_t* __restrict__ x, const int64_t* __restrict__ q,
    const int64_t* __restrict__ r, const int64_t* __restrict__ sq,
    const int64_t* __restrict__ sr, uint32_t& idx, uint32_t& bits) {
  uint32_t cum = 0;
  idx = 0;
  bits = 0;
  auto finish = [&](int j, uint64_t acc, uint64_t sacc) {
    const uint32_t h = mod_p31_53(acc);
    idx += (h - div_by(divs.range[j], h) * plan.ranges[j]) * plan.strides[j];
    if constexpr (kSigned) {
      cum ^= mod_p31_53(sacc) & 1u;
      bits |= cum << j;
    }
  };
  if (kChunks > 0) {
    int j = 0, end = plan.group_start[1];
    uint64_t acc = lo32(r, 0), sacc = 0;
    if constexpr (kSigned) sacc = lo32(sr, 0);
#pragma unroll
    for (int t = 0; t < (kChunks > 0 ? kChunks : 1); ++t) {
      if (t < plan.group_start[plan.n_groups]) {
        const int c = plan.cols[t];
        acc += (uint64_t)lo32(q, c) * xr[t];
        if constexpr (kSigned) sacc += (uint64_t)lo32(sq, c) * xr[t];
        if (t + 1 == end) {
          finish(j, acc, sacc);
          if (++j < plan.n_groups) {
            acc = lo32(r, j);
            if constexpr (kSigned) sacc = lo32(sr, j);
            end = plan.group_start[j + 1];
          }
        }
      }
    }
  } else {
    for (int j = 0; j < plan.n_groups; ++j) {
      uint64_t acc = lo32(r, j), sacc = 0;
      if constexpr (kSigned) sacc = lo32(sr, j);
      for (int t = plan.group_start[j]; t < plan.group_start[j + 1]; ++t) {
        const int c = plan.cols[t];
        const uint32_t xc = lo32(x, c);
        acc += (uint64_t)lo32(q, c) * xc;
        if constexpr (kSigned) sacc += (uint64_t)lo32(sq, c) * xc;
      }
      finish(j, acc, sacc);
    }
  }
}

// A key's chunks in registers for index_and_sign_bits<kChunks> (nothing
// when kChunks is 0): chunk t in group-major order, 0 past the last and on
// a lane that holds no key (`live` false: x is not read).
template <int kChunks>
__device__ __forceinline__ void load_chunks(const IndexPlanC& plan,
                                            const int64_t* __restrict__ x, bool live,
                                            uint32_t* xr) {
#pragma unroll
  for (int t = 0; t < kChunks; ++t) {
    xr[t] = live && t < plan.group_start[plan.n_groups] ? lo32(x, plan.cols[t]) : 0u;
  }
}
