// K0: the composite Carter-Wegman cell index, as a __device__ helper, and
// K0s: the packed signed-mode sign bits beside it.
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
// a 64-bit division, and `% range_j` runs in 32 bits because the folded value
// is below 2^31.
//
// The plan is a small struct passed by value as a __grid_constant__ kernel
// parameter: nothing about the spec is specialised at compile time.
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

__device__ __forceinline__ uint32_t sk_mod_p31(uint64_t x) {
  const uint64_t P = 0x7FFFFFFFull;
  x = (x >> 31) + (x & P);  // < 2^32 for x < 2^62
  x = (x >> 31) + (x & P);  // <= 2^31
  return (uint32_t)(x >= P ? x - P : x);
}

// Cell index of the key whose chunks start at `x`, for the row whose params
// start at `q` (total_chunks entries) and `r` (n_groups entries).  Callers
// guarantee the table size is below 2^31, so the sum fits uint32.
__device__ __forceinline__ uint32_t composite_index(const IndexPlanC& plan,
                                                    const int64_t* __restrict__ x,
                                                    const int64_t* __restrict__ q,
                                                    const int64_t* __restrict__ r) {
  uint32_t idx = 0;
  for (int j = 0; j < plan.n_groups; ++j) {
    uint64_t acc = (uint64_t)r[j];
    for (int t = plan.group_start[j]; t < plan.group_start[j + 1]; ++t) {
      const int c = plan.cols[t];
      acc += (uint64_t)q[c] * (uint64_t)x[c];
    }
    idx += (sk_mod_p31(acc) % plan.ranges[j]) * plan.strides[j];
  }
  return idx;
}

// K0s replaces src/repro/kernels/hashes.py `row_sign_bits` and
// `signs_from_bits` (inlined in the signed Pallas kernels).  One CW pass per
// group under the sign params; bit j of the result is the XOR of the hash
// parities of groups 0..j, i.e. the sign of the level-j prefix (1 = -1).  The
// parity is taken of the canonical residue in [0, P31) that sk_mod_p31
// returns -- the low bit of an unreduced 64-bit sum would be another bit.
__device__ __forceinline__ uint32_t composite_sign_bits(const IndexPlanC& plan,
                                                        const int64_t* __restrict__ x,
                                                        const int64_t* __restrict__ sq,
                                                        const int64_t* __restrict__ sr) {
  uint32_t bits = 0, cum = 0;
  for (int j = 0; j < plan.n_groups; ++j) {
    uint64_t acc = (uint64_t)sr[j];
    for (int t = plan.group_start[j]; t < plan.group_start[j + 1]; ++t) {
      const int c = plan.cols[t];
      acc += (uint64_t)sq[c] * (uint64_t)x[c];
    }
    cum ^= sk_mod_p31(acc) & 1u;
    bits |= cum << j;
  }
  return bits;
}

// v or -v as the sign bit says, in two's complement (no signed overflow).
__device__ __forceinline__ int32_t sk_apply_sign(int32_t v, uint32_t negative) {
  return negative ? (int32_t)(0u - (uint32_t)v) : v;
}

// The float32 form: the reference multiplies by s = +-1 in float32, which
// is an exact negation.
__device__ __forceinline__ float sk_apply_sign(float v, uint32_t negative) {
  return negative ? -v : v;
}
