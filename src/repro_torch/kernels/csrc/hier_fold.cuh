// The fused hierarchy fold, one body for K3 (unsigned) and K8 (signed), on
// int32 and float32 tables (K3f, K8f), and its launcher.  The flat folds K1
// and K1f are its one-level unsigned case (offset 0, divisor 1;
// sketch_kernels.cu `launch_flat_fold`).  The signed flat fold K6 is not:
// its sign is the packed bits' last, where a one-level signed fold would
// read bit 0.  Included by sketch_kernels.cu (K1, K1f, K3, K3f) and
// signed_kernels.cu (K8, K8f); conservative_kernels.cu takes opt_in_smem
// from here.
//
// K3 replaces src/repro/kernels/hier_update.py `hier_update_pallas`
// (`_hier_kernel_int`, `_local_lanes`, `_tile_meta`; as K3f,
// `_hier_kernel_f32`), K8 `hier_update_signed_pallas` (`_hier_kernel_signed_int`,
// `_tile_meta_signed`; as K8f, `_hier_kernel_signed_f32`).  Each folds a
// block into every level of the concatenated [w, cols] table: hash the
// finest index (and, signed, the packed sign bits) once per (row k, key b),
// then level l adds f (signed: s_l * f, s_l being bit l) at offsets[l] +
// idx / divs[l].  The finest index is below 2^31 (make_hier_plan), so the
// unsigned division equals jax.lax.div.
//
// What bounded the first design (one thread per (row, key), gridDim.y = w,
// L global atomics each), as chip_smoke.py measured it on an H100 80GB
// HBM3 at 700 W: (1) same-address atomics on the coarse levels.  A level-0
// cell is shared by every key of a prefix -- a matrix row of a gradient
// leaf, a heavy source of the stream -- and those adds serialise in L2.
// At the compressor's embed leaf (226.5M keys, w = 3) that put 680M float
// atomics onto 6,516 addresses: 68.15 ms against 48.56 for `index_add_` of
// the same values; on the turnstile block, whose top source holds 3,180 of
// 65,536 rows, 42.33 us against 37.70.  (2) Each key's chunks and value
// were read from DRAM once per row, w times.
//
// What bounds this design: integer issue.  A key costs about 200
// instructions a row signed (two Carter-Wegman passes, the range
// reductions, the level divisions, the aggregation), about half of that
// unsigned; the finest level's random atomics are issued without waiting,
// and the keys' bytes are read once.  chip_smoke.py's K8f bound probes show
// it: the same keys into a finest level that fits L2 take as long, and
// all-zero values, which skip the hashing, a small fraction of the time.
//
// The design: one thread per key runs all w rows, so a key's chunks and
// value leave DRAM once -- held in registers when the key has at most
// kRegChunks chunks -- and each thread has w x L independent atomics in
// flight.  The hash is hashes.cuh's fused index_and_sign_bits (signed: K0
// and K0s in one pass) with 32 x 32 -> 64-bit products, and every division
// by a range or a level divisor is a multiply and a shift (DivisorC).  A
// CTA walks spans of `span_tiles` consecutive tiles of kFoldThreads keys,
// grid-stride (span s goes to CTA s mod gridDim.x), so one CTA meets long
// runs of keys that share a coarse cell, and a sparse leaf's nonzero rows
// spread over every CTA.  Each level
// whose bit is set in `shared_mask` is folded into a private copy in shared
// memory (w x its padded columns): the lanes of a warp that hit one cell
// are first combined (__match_any_sync, then __reduce_add_sync on int32 or
// a shuffle tree on float32, whose shared atomicAdd the compiler makes a
// compare-and-swap loop) and their leader adds once; at the end the CTA
// adds each nonzero cell of its copy to the table with one global atomic.
// The other levels add with global atomics directly.  The residency rule
// (kernels/hier_update.py `fold_geometry`) picks the shared levels, the
// CTAs and the span; both routes are this body.  K1 folds with global
// atomics only, in the CTAs and spans of kernels/sketch_update.py
// `flat_deal`.  int32 adds wrap, so any
// grouping of them gives the plain fold's table; float32 adds are exact
// while every partial sum is an integer below 2^24 (the reference's
// contract, hier_update.py:35-38).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "hashes.cuh"

namespace sk_fold {
namespace {

constexpr int kFoldThreads = 256;           // hier_update.THREADS: the keys of a tile
constexpr int kHierCtasPerSm = 4;           // hier_update.CTAS_PER_SM
constexpr int kFlatCtasPerSm = 8;           // sketch_update.FLAT_CTAS_PER_SM
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNoCell = 0xffffffffu;   // a dead lane's cell: above any real one

// The finest plan's group ranges (the hash's, hashes.cuh) and the levels'
// divisors.
struct HierDivsC {
  HashDivsC hash;
  DivisorC level[SK_MAX_LEVELS];
};

// The sum of v over the lanes in `peers` (the calling lane among them),
// complete in the lowest of them.  Every lane of the warp calls it.
__device__ __forceinline__ int32_t peer_sum(unsigned peers, int32_t v) {
  return __reduce_add_sync(peers, v);
}

__device__ __forceinline__ float peer_sum(unsigned peers, float v) {
  if (peers == kFull) {   // one cell for the whole warp (uniform): a butterfly
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    return v;
  }
  const unsigned lane = threadIdx.x & 31u;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));   // place among the peers
  unsigned above = peers & (0xfffffffeu << lane);        // peers on higher lanes
  // a binary tree: each round, every peer still in adds the next one above
  // it, and the peers at odd places drop out
  while (__any_sync(kFull, above != 0u)) {
    const int next = __ffs(above);
    const float t = __shfl_sync(kFull, v, (next - 1) & 31);
    if (next) v += t;
    above &= ~__ballot_sync(kFull, rank & 1u);
    rank >>= 1;
  }
  return v;
}

// Columns of level l in the concatenated table, its padding included.
__host__ __device__ __forceinline__ int64_t level_cols(const LevelsC& levels, int64_t cols,
                                                       int l) {
  return (l + 1 < levels.n_levels ? levels.offsets[l + 1] : cols) - levels.offsets[l];
}

// The body of both folds; see the top of this file.  kFlat is K1's
// one-level case: a CTA folds one row, blockIdx.y, with global atomics
// only (no level in shared memory), and the level's division by 1 is
// skipped.
template <typename T, int kChunks, bool kSigned, bool kFlat = false>
__device__ __forceinline__ void hier_fold(const IndexPlanC& plan, const LevelsC& levels,
                                          T* __restrict__ table, int64_t cols, int32_t w,
                                          const int64_t* __restrict__ chunks,
                                          const T* __restrict__ freqs, int64_t n,
                                          const int64_t* __restrict__ q,
                                          const int64_t* __restrict__ r,
                                          const int64_t* __restrict__ sq,
                                          const int64_t* __restrict__ sr,
                                          const HierDivsC& divs, uint32_t shared_mask,
                                          int64_t span_tiles) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  T* copy = reinterpret_cast<T*>(sk_smem);
  const int n_levels = kFlat ? 1 : levels.n_levels;
  const uint32_t shared_levels = kFlat ? 0u : shared_mask;
  const int k_begin = kFlat ? (int)blockIdx.y : 0;   // the rows this CTA folds
  const int k_end = kFlat ? k_begin + 1 : w;
  int64_t copy_cells = 0;
  for (int l = 0; l < n_levels; ++l) {
    if ((shared_levels >> l) & 1u) copy_cells += w * level_cols(levels, cols, l);
  }
  for (int64_t i = threadIdx.x; i < copy_cells; i += blockDim.x) copy[i] = T(0);
  __syncthreads();

  const unsigned lane = threadIdx.x & 31u;
  const int64_t span = span_tiles * blockDim.x;
  for (int64_t start = (int64_t)blockIdx.x * span; start < n;
       start += (int64_t)gridDim.x * span) {
    const int64_t end = start + span < n ? start + span : n;
    for (int64_t tile = start; tile < end; tile += blockDim.x) {
      const int64_t b = tile + threadIdx.x;
      const T f = b < end ? freqs[b] : T(0);
      const bool live = f != T(0);
      if (!__any_sync(kFull, live)) continue;   // warp-uniform: a zero stretch
      const int64_t* x = chunks + b * plan.total_chunks;
      uint32_t xr[kChunks > 0 ? kChunks : 1];
      load_chunks<kChunks>(plan, x, live, xr);
      for (int k = k_begin; k < k_end; ++k) {
        uint32_t idx = 0, bits = 0;
        if (live) {
          const int64_t* sqk = nullptr;
          const int64_t* srk = nullptr;
          if constexpr (kSigned) {
            sqk = sq + k * plan.total_chunks;
            srk = sr + k * plan.n_groups;
          }
          index_and_sign_bits<kChunks, kSigned>(plan, divs.hash, xr, x,
                                                q + k * plan.total_chunks,
                                                r + k * plan.n_groups, sqk, srk, idx, bits);
        }
        T* row = table + k * cols;
        int64_t base = 0;   // level l's copy in shared memory
        for (int l = 0; l < n_levels; ++l) {
          const uint32_t col = kFlat ? idx : div_by(divs.level[l], idx);
          T v = f;
          if constexpr (kSigned) v = sk_apply_sign(f, (bits >> l) & 1u);
          const int64_t h = level_cols(levels, cols, l);
          if ((shared_levels >> l) & 1u) {
            const unsigned peers = __match_any_sync(kFull, live ? col : kNoCell);
            const T sum = peer_sum(peers, v);
            if (live && lane == (unsigned)(__ffs(peers) - 1) && sum != T(0)) {
              atomicAdd(copy + base + k * h + col, sum);
            }
            base += w * h;
          } else if (live) {
            atomicAdd(row + levels.offsets[l] + col, v);
          }
        }
      }
    }
  }
  __syncthreads();

  int64_t base = 0;
  for (int l = 0; l < n_levels; ++l) {
    if (!((shared_levels >> l) & 1u)) continue;
    const int64_t h = level_cols(levels, cols, l);
    for (int k = 0; k < w; ++k) {
      T* row = table + k * cols + levels.offsets[l];
      for (int64_t c = threadIdx.x; c < h; c += blockDim.x) {
        const T v = copy[base + k * h + c];
        if (v != T(0)) atomicAdd(row + c, v);
      }
    }
    base += w * h;
  }
}

// K3 / K3f: the unsigned fold.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kFoldThreads, kHierCtasPerSm)
    sk_hier_update_kernel(const __grid_constant__ IndexPlanC plan,
                          const __grid_constant__ LevelsC levels, T* __restrict__ table,
                          int64_t cols, int32_t w, const int64_t* __restrict__ chunks,
                          const T* __restrict__ freqs, int64_t n,
                          const int64_t* __restrict__ q, const int64_t* __restrict__ r,
                          const __grid_constant__ HierDivsC divs, uint32_t shared_mask,
                          int64_t span_tiles) {
  hier_fold<T, kChunks, false>(plan, levels, table, cols, w, chunks, freqs, n, q, r, nullptr,
                               nullptr, divs, shared_mask, span_tiles);
}

// K1 / K1f: the one-level fold, a CTA a row (gridDim.y = w).  A thread
// hashes one row of its key, so the bounds ask for the registers of eight
// CTAs an SM (32 a thread), as the first K1 ran; with K3's four the
// instance took 48.  It reads a key's chunks where the hash uses them
// (kChunks 0): staging them for one row bought nothing and cost a median
// 4% (tools/fold_ab.py --spans).
template <typename T>
__global__ void __launch_bounds__(kFoldThreads, kFlatCtasPerSm)
    sk_flat_update_kernel(const __grid_constant__ IndexPlanC plan,
                          const __grid_constant__ LevelsC levels, T* __restrict__ table,
                          int64_t cols, int32_t w, const int64_t* __restrict__ chunks,
                          const T* __restrict__ freqs, int64_t n,
                          const int64_t* __restrict__ q, const int64_t* __restrict__ r,
                          const __grid_constant__ HierDivsC divs, uint32_t shared_mask,
                          int64_t span_tiles) {
  hier_fold<T, 0, false, true>(plan, levels, table, cols, w, chunks, freqs, n, q, r, nullptr,
                               nullptr, divs, shared_mask, span_tiles);
}

// K8 / K8f: the signed fold.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kFoldThreads, kHierCtasPerSm)
    sk_hier_update_signed_kernel(const __grid_constant__ IndexPlanC plan,
                                 const __grid_constant__ LevelsC levels,
                                 T* __restrict__ table, int64_t cols, int32_t w,
                                 const int64_t* __restrict__ chunks,
                                 const T* __restrict__ freqs, int64_t n,
                                 const int64_t* __restrict__ q,
                                 const int64_t* __restrict__ r,
                                 const int64_t* __restrict__ sq,
                                 const int64_t* __restrict__ sr,
                                 const __grid_constant__ HierDivsC divs,
                                 uint32_t shared_mask, int64_t span_tiles) {
  hier_fold<T, kChunks, true>(plan, levels, table, cols, w, chunks, freqs, n, q, r, sq, sr,
                              divs, shared_mask, span_tiles);
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in first.  The
// opt-in is kept per kernel and device: cudaFuncSetAttribute runs only when
// a kernel on the current device is asked for more bytes than it was
// granted, so a launcher called once a block pays it once.  A refused
// attribute (like a refused launch) is returned, never swallowed, and taken
// off the thread's last error so no later launch reports it.
struct SmemGrant {
  const void* kernel;
  int device;
  size_t bytes;
};
constexpr int kMaxGrants = 64;   // kernel instances x devices; beyond, no caching
std::mutex grant_lock;
SmemGrant grants[kMaxGrants];
int n_grants = 0;

template <typename K>
int opt_in_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const void* fn = (const void*)kernel;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  std::lock_guard<std::mutex> hold(grant_lock);
  SmemGrant* g = nullptr;
  for (int i = 0; i < n_grants; ++i) {
    if (grants[i].kernel == fn && grants[i].device == device) g = &grants[i];
  }
  if (g != nullptr && g->bytes >= smem) return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  if (g == nullptr && n_grants < kMaxGrants) g = &grants[n_grants++];
  if (g != nullptr) *g = {fn, device, smem};
  return 0;
}

// Launches K3 (kSigned false; sq and sr unused), K8, or with kFlat K1 (one
// level, offset 0, divisor 1, no shared level; `ctas` CTAs for each of the
// w rows) on the caller's stream.  `smem` is the shared bytes the Python rule computed
// for `shared_mask`; a launch whose figure disagrees with the levels' is
// refused.
template <typename T, bool kSigned, bool kFlat = false>
int launch_hier_fold(const IndexPlanC* plan, const LevelsC* levels, T* table, int64_t cols,
                     int32_t w, const int64_t* chunks, const T* freqs, int64_t n,
                     const int64_t* q, const int64_t* r, const int64_t* sq,
                     const int64_t* sr, uint32_t shared_mask, int32_t ctas,
                     int64_t span_tiles, int64_t smem, void* stream) {
  if (n <= 0) return 0;
  int64_t want = 0;
  for (int l = 0; l < levels->n_levels; ++l) {
    if ((shared_mask >> l) & 1u) want += (int64_t)w * level_cols(*levels, cols, l) * sizeof(T);
  }
  if (want != smem || ctas <= 0 || span_tiles <= 0 || (shared_mask >> levels->n_levels) != 0) {
    return (int)cudaErrorInvalidValue;
  }
  HierDivsC divs{make_hash_divs(*plan), {}};
  for (int l = 0; l < levels->n_levels; ++l) divs.level[l] = make_divisor(levels->divs[l]);
  const bool in_registers = chunks_in_registers(*plan);
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (kSigned) {
    auto kernel = in_registers ? sk_hier_update_signed_kernel<T, kRegChunks>
                               : sk_hier_update_signed_kernel<T, 0>;
    const int rc = opt_in_smem(kernel, (size_t)smem);
    if (rc) return rc;
    kernel<<<ctas, kFoldThreads, (size_t)smem, s>>>(*plan, *levels, table, cols, w, chunks,
                                                     freqs, n, q, r, sq, sr, divs,
                                                     shared_mask, span_tiles);
  } else {
    auto kernel = kFlat ? sk_flat_update_kernel<T>
                        : (in_registers ? sk_hier_update_kernel<T, kRegChunks>
                                        : sk_hier_update_kernel<T, 0>);
    const int rc = opt_in_smem(kernel, (size_t)smem);
    if (rc) return rc;
    const dim3 grid((unsigned)ctas, kFlat ? (unsigned)w : 1u);
    kernel<<<grid, kFoldThreads, (size_t)smem, s>>>(*plan, *levels, table, cols, w, chunks,
                                                     freqs, n, q, r, divs, shared_mask,
                                                     span_tiles);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sk_fold
