// The candidate-grid queries, one body for K4 (the Count-Min minimum), K4f
// (K4 on float32 tables), K9 (the signed rows) and K9m (K9 with the median
// over rows fused into the launch), and their launcher.  Included by
// sketch_kernels.cu (K4, K4f) and signed_kernels.cu (K9, K9m), through
// point_query.cuh, whose flat point queries (K2, K7, K7m) take their
// outputs from this body's `emit`.
//
// K4 replaces src/repro/kernels/hier_query.py `hier_candidate_query`
// (`_hier_kernel`) and, with Q requests flattened onto the prefix axis,
// `hier_candidate_query_batched`; K4f the same grid on float32 tables,
// which the reference computes in jnp (`hier_candidate_query_ref`,
// src/repro/core/hierarchy.py:560: the decayed window's tables); K9
// `hier_candidate_query_signed`
// (`_hier_kernel_signed`); K9m that kernel and the median over rows the
// reference takes after it (src/repro/core/countsketch.py:371).  Child
// (p, c) of row k lives at cell pp[k, p] + cp[k, c] of a level table whose
// rows are `row_stride` apart (a level view of the concatenated hierarchy
// table: its base offset is in the pointer, so no level is copied); its
// sign, for K9 and K9m, is sp[k, p] * sc[k, c].
//
// What bounded the first design (K4: one thread per (p, c) lane, its rows
// in a loop of runtime trip count; K9: one thread per (row, p, c) lane,
// gridDim.y = w), as chip_smoke.py measured it on an H100 80GB HBM3 at
// 700 W: K4 took 3.99 us on the device at 16 x 4,096 against a 0.30 us
// bound, each row's partial load and then its dependent cell load in a
// chain of 2w accesses, and it read a prefix's window one 32-byte sector a
// lane; K9 could not reduce over rows, so it wrote int32 [w, P, C] (3.06 MB
// at the turnstile's 1 x 191,300) for torch's sort to take the median of,
// which cost 18x K9.
//
// The design: one thread per (p, c) lane over all w rows.  kW (1 to 8)
// unrolls the rows, so a thread issues its w child-partial loads, then its w
// cell loads, before the first use: a lane waits for one partial access and
// one cell access, not 2w.  Wider w takes a runtime loop.  A CTA covers one
// prefix and a run of `c_tile` candidates: the prefix's partials and signs
// are CTA-uniform loads into registers, cp and sc are read coalesced.  The
// window route stages the w x `span` cells a prefix's children can hit (the
// child partial has stride 1 and is below the level's last range, which the
// callers pass as `span`) into shared memory, one bulk asynchronous copy
// (TMA, cp.async.bulk) a row of its 16-byte-aligned interior, completed on
// an mbarrier, and its unaligned ends with plain loads; the lanes then
// gather from shared memory.  A lane whose child partial is not below the
// staged length reads global memory, and a window never reaches past the
// view's columns, so neither the answer nor the memory read depends on
// span.  kernels/hier_query.py's `query_geometry` picks the route and
// c_tile.
//
// What bounds it (tools/query_ab.py and chip_smoke.py, H100 80GB HBM3 at
// 700 W, L2 evicted).  The compiled lane loop (cuobjdump -sass of
// sk_hier_query_kernel<4>) issues the first candidate's four child-partial
// loads before the prefix's partials and the staging, and in the loop four
// cell loads (predicated LDG from global, LDS from the window) before the
// next candidate's four child-partial loads and the reduction.  Small grids
// are then bound by the launch and two dependent DRAM round trips: 2.5-2.6
// us at 1 x 4,096 (the first design 2.36: its compiled loop had its loads
// in flight too, so there was no chain of 2w to remove), 3.8-4.0 at
// 16 x 4,096 (4.0-4.1).  Wide grids are bound by moving the windows: at
// 2,190 x 4,096, 100-102 us on the window route, 222 on the direct route,
// 234 in the first design; 30% of the bytes bound.  K9m at 1 x 191,300,
// 8.3-8.7 us, reads 6.1 of its 7.0 MB as int64 child partials.
//
// K9m's median: each row's value is float((int32)(v * s)), the int32
// product K9 writes cast as median_rows casts K9's rows; an odd-even
// transposition network in registers (the network core/countsketch.py's
// median_rows runs on tensors) sorts the kW values, and the median is the
// middle one, or for even w (x[w/2 - 1] + x[w/2]) * 0.5 with no
// contraction, as jnp.median rounds it.  The runtime-w path takes the two
// order statistics by rank (w^2 comparisons).  No int32 value casts to NaN,
// so K9m equals median_rows(K9(...)) bit for bit on every int32 table.
// K4f: the cell type T of the body is float.  Both types are 4 bytes, so
// the window route stages the same cells and the route rule holds.  The
// minimum is a plain `<` selection: decayed tables are finite and
// non-negative, their zeros +0.0, so it equals torch.min over rows bit for
// bit (no fminf, whose NaN rule differs).  K9 and K9m stay int32.  Bound
// as K4 is: on the decayed window's grids (chip_smoke.py, H100 80GB HBM3
// at 700 W) 2.6 us at 1 x 4,096 and 3.9 at 16 x 4,096 on the device, K4's
// time at those grids within 3%.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "hier_fold.cuh"   // sk_fold::opt_in_smem

namespace sk_query {
namespace {

constexpr int kQueryThreads = 256;   // hier_query.THREADS
constexpr int kUnrolledRows = 8;     // hier_query.UNROLLED_ROWS
constexpr int kBarBytes = 16;        // the window's mbarrier, after the rows

enum QueryOut { kOutMin = 0, kOutRows = 1, kOutMedian = 2 };

struct QueryArgs {
  const void* table;      // int32 or float (K4f): row k at table + k * row_stride
  int64_t row_stride;
  int64_t cols;           // the view's columns: no window reaches past them
  int32_t w;
  const int64_t* pp;      // [w, P] prefix partials
  const float* sp;        // [w, P] prefix signs (K9, K9m)
  int64_t P;
  const int64_t* cp;      // [w, C] child partials
  const float* sc;        // [w, C] child signs (K9, K9m)
  int64_t C;
  int64_t span;           // cells a row the window route stages (0: direct route)
  int64_t pitch;          // cells a staged row takes in shared memory
  int64_t c_tile;         // candidates a CTA
  int64_t c_tiles;        // CTAs a prefix
  void* out;              // T [P, C] (K4, K4f), int32 [w, P, C] (K9), float [P, C] (K9m)
};

// A staged row holds `span` cells from its 16-byte-aligned start, which is
// up to 3 cells before the window.
__host__ __device__ __forceinline__ int64_t window_pitch(int64_t span) {
  return (span + 7) & ~int64_t(3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// The one arrival of the barrier's phase 0, expecting `bytes` of copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 state;\n mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}"
      ::"r"(smem_addr(bar)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// TMA's 1-D bulk copy, global to this CTA's shared memory: both addresses
// 16-byte aligned, `bytes` a multiple of 16.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Row k's cells for one prefix: the window [at, at + len) of the row
// (len 0 on the direct route), staged from `head` cells into its shared row.
template <typename T>
struct RowWindow {
  static_assert(sizeof(T) == 4, "the window route stages 4-byte cells");
  const T* at;
  int32_t len;
  int32_t head;
};

template <typename T>
__device__ __forceinline__ RowWindow<T> row_window(const QueryArgs& a, int k, int64_t pp) {
  const T* row = static_cast<const T*>(a.table) + k * a.row_stride;
  RowWindow<T> r{row + pp, 0, 0};
  if (a.span > 0 && pp >= 0 && pp < a.cols) {
    r.len = (int32_t)(a.span < a.cols - pp ? a.span : a.cols - pp);
    r.head = (int32_t)(((uintptr_t)r.at & 15u) >> 2);
  }
  return r;
}

// The 16-byte-aligned interior [lo, hi) of a row's window, in cells from
// `at` (lo == hi when there is none).
template <typename T>
__device__ __forceinline__ void window_interior(const RowWindow<T>& r, int32_t& lo, int32_t& hi) {
  lo = (4 - r.head) & 3;
  hi = ((r.head + r.len) & ~3) - r.head;
  if (hi <= lo) lo = hi = min(lo, r.len);
}

template <typename T>
__device__ __forceinline__ T cell(const RowWindow<T>& r, const T* win, int64_t child) {
  if ((uint64_t)child < (uint64_t)r.len) return win[r.head + child];
  return __ldg(r.at + child);
}

// Stages prefix p's windows, row k at win + k * pitch.  Every thread of the
// CTA calls it.
template <typename T>
__device__ __forceinline__ void stage_windows(const QueryArgs& a, int w, int64_t p, T* win,
                                              uint64_t* bar) {
  if (threadIdx.x == 0) mbar_init(bar);
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t bytes = 0;
    for (int k = 0; k < w; ++k) {
      int32_t lo, hi;
      window_interior(row_window<T>(a, k, a.pp[k * a.P + p]), lo, hi);
      bytes += 4u * (uint32_t)(hi - lo);
    }
    mbar_expect(bar, bytes);
    for (int k = 0; k < w; ++k) {
      const RowWindow<T> r = row_window<T>(a, k, a.pp[k * a.P + p]);
      int32_t lo, hi;
      window_interior(r, lo, hi);
      if (hi > lo) bulk_copy(win + k * a.pitch + r.head + lo, r.at + lo, 4u * (hi - lo), bar);
    }
  }
  // the ends outside the interior: at most 3 cells before it, and after it
  // at most 3 (or, with no interior, the whole window of at most 6)
  for (int i = threadIdx.x; i < w * 12; i += blockDim.x) {
    const int k = i / 12, j = i - k * 12;
    const RowWindow<T> r = row_window<T>(a, k, a.pp[k * a.P + p]);
    int32_t lo, hi;
    window_interior(r, lo, hi);
    const int32_t x = j < 4 ? j : hi + (j - 4);
    if (x < (j < 4 ? lo : r.len)) win[k * a.pitch + r.head + x] = r.at[x];
  }
  __syncthreads();
  mbar_wait(bar, 0);
}

__device__ __forceinline__ int32_t sign_of(float sp, float sc) {
  return (int32_t)sp * (int32_t)sc;
}

// v * s in int32, wrapping as the reference's kernel does.
__device__ __forceinline__ int32_t signed_product(int32_t v, int32_t s) {
  return (int32_t)((uint32_t)v * (uint32_t)s);
}

__device__ __forceinline__ float midpoint(float lo, float hi) {
  return __fmul_rn(__fadd_rn(lo, hi), 0.5f);
}

// The runtime-w median of value(0) .. value(w - 1): the order statistics
// (w - 1) / 2 and w / 2 taken by rank (w^2 comparisons, each value
// recomputed), then rounded as the unrolled network's.
template <typename Value>
__device__ __forceinline__ float median_by_rank(int w, Value value) {
  const int lo_rank = (w - 1) / 2, hi_rank = w / 2;
  float lo = 0.0f, hi = 0.0f;
  for (int j = 0; j < w; ++j) {
    const float xj = value(j);
    int less = 0, leq = 0;
    for (int i = 0; i < w; ++i) {
      const float xi = value(i);
      less += xi < xj;
      leq += xi <= xj;
    }
    if (less <= lo_rank && lo_rank < leq) lo = xj;
    if (less <= hi_rank && hi_rank < leq) hi = xj;
  }
  return (w & 1) ? lo : midpoint(lo, hi);
}

// Runtime w: row k's signed value of lane (p, c), its partials reloaded.
__device__ __forceinline__ float signed_value(const QueryArgs& a, const int32_t* win,
                                              int k, int64_t p, int64_t c) {
  const RowWindow<int32_t> r = row_window<int32_t>(a, k, a.pp[k * a.P + p]);
  const int32_t v = cell(r, win + k * a.pitch, a.cp[k * a.C + c]);
  return (float)signed_product(v, sign_of(a.sp[k * a.P + p], a.sc[k * a.C + c]));
}

// Candidate c's child partials (and, signed, its signs), one load a row.
template <int kW, int kOut>
__device__ __forceinline__ void load_children(const QueryArgs& a, int64_t c,
                                              int64_t (&child)[kW], float (&sc)[kW]) {
#pragma unroll
  for (int k = 0; k < kW; ++k) {
    child[k] = __ldg(a.cp + k * a.C + c);
    if constexpr (kOut != kOutMin) sc[k] = __ldg(a.sc + k * a.C + c);
  }
}

// Lane (p, c)'s output from its kW cells v and signs s.  The minimum is a
// `<` selection (for int32 the same as min, for K4f's floats see the top).
template <int kW, int kOut, typename T>
__device__ __forceinline__ void emit(const QueryArgs& a, int64_t p, int64_t c,
                                     const T (&v)[kW], const int32_t (&s)[kW]) {
  if constexpr (kOut == kOutMin) {
    T best = v[0];
#pragma unroll
    for (int k = 1; k < kW; ++k) best = v[k] < best ? v[k] : best;
    static_cast<T*>(a.out)[p * a.C + c] = best;
  } else if constexpr (kOut == kOutRows) {
    static_assert(std::is_same<T, int32_t>::value, "the signed rows are int32");
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      static_cast<int32_t*>(a.out)[(k * a.P + p) * a.C + c] = signed_product(v[k], s[k]);
    }
  } else {
    static_assert(std::is_same<T, int32_t>::value, "the signed median reads int32");
    float x[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) x[k] = (float)signed_product(v[k], s[k]);
#pragma unroll
    for (int round = 0; round < kW; ++round) {
#pragma unroll
      for (int i = round & 1; i + 1 < kW; i += 2) {
        const float lo = fminf(x[i], x[i + 1]), hi = fmaxf(x[i], x[i + 1]);
        x[i] = lo;
        x[i + 1] = hi;
      }
    }
    static_cast<float*>(a.out)[p * a.C + c] =
        (kW & 1) ? x[kW / 2] : midpoint(x[kW / 2 - 1], x[kW / 2]);
  }
}

// The body of K4, K4f, K9 and K9m; see the top of this file.
template <int kW, int kOut, typename T = int32_t>
__device__ __forceinline__ void hier_query(const QueryArgs& a) {
  extern __shared__ __align__(16) unsigned char sk_query_smem[];
  T* win = reinterpret_cast<T*>(sk_query_smem);
  const uint32_t tiles = (uint32_t)a.c_tiles;
  const uint32_t pt = blockIdx.x / tiles;
  const int64_t p = pt;
  const int64_t c0 = (int64_t)(blockIdx.x - pt * tiles) * a.c_tile;
  const int64_t c_end = c0 + a.c_tile < a.C ? c0 + a.c_tile : a.C;
  const int w = kW > 0 ? kW : a.w;
  uint64_t* bar = reinterpret_cast<uint64_t*>(win + w * a.pitch);

  if constexpr (kW > 0) {
    // The first candidate's child partials are issued before the prefix's
    // partials are read and the window staged, and each next candidate's
    // before this one's cells are reduced, so no load waits on another it
    // does not depend on.
    int64_t c = c0 + threadIdx.x;
    int64_t child[kW];
    float sc[kW];
    if (c < c_end) load_children<kW, kOut>(a, c, child, sc);
    if (a.span > 0) stage_windows(a, w, p, win, bar);
    RowWindow<T> rw[kW];
    float sp[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      rw[k] = row_window<T>(a, k, a.pp[k * a.P + p]);
      if constexpr (kOut != kOutMin) sp[k] = a.sp[k * a.P + p];
    }
    while (c < c_end) {
      T v[kW];
      int32_t s[kW];
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        v[k] = cell(rw[k], win + k * a.pitch, child[k]);
        if constexpr (kOut != kOutMin) s[k] = sign_of(sp[k], sc[k]);
      }
      const int64_t at = c;
      c += blockDim.x;
      if (c < c_end) load_children<kW, kOut>(a, c, child, sc);
      emit<kW, kOut>(a, p, at, v, s);
    }
  } else {
    if (a.span > 0) stage_windows(a, w, p, win, bar);
    for (int64_t c = c0 + threadIdx.x; c < c_end; c += blockDim.x) {
      if constexpr (kOut == kOutMedian) {
        static_cast<float*>(a.out)[p * a.C + c] =
            median_by_rank(w, [&](int k) { return signed_value(a, win, k, p, c); });
      } else {
        T best = T(0);
        for (int k = 0; k < w; ++k) {
          const RowWindow<T> r = row_window<T>(a, k, a.pp[k * a.P + p]);
          const T v = cell(r, win + k * a.pitch, __ldg(a.cp + k * a.C + c));
          if constexpr (kOut == kOutMin) {
            best = (k == 0 || v < best) ? v : best;
          } else {
            static_cast<int32_t*>(a.out)[(k * a.P + p) * a.C + c] =
                signed_product(v, sign_of(a.sp[k * a.P + p], a.sc[k * a.C + c]));
          }
        }
        if constexpr (kOut == kOutMin) static_cast<T*>(a.out)[p * a.C + c] = best;
      }
    }
  }
}

// K4: the Count-Min minimum over rows.
template <int kW>
__global__ void __launch_bounds__(kQueryThreads)
    sk_hier_query_kernel(const __grid_constant__ QueryArgs a) {
  hier_query<kW, kOutMin>(a);
}

// K4f: K4 on float32 tables.
template <int kW>
__global__ void __launch_bounds__(kQueryThreads)
    sk_hier_query_f32_kernel(const __grid_constant__ QueryArgs a) {
  hier_query<kW, kOutMin, float>(a);
}

// K9: the signed rows.
template <int kW>
__global__ void __launch_bounds__(kQueryThreads)
    sk_hier_query_signed_kernel(const __grid_constant__ QueryArgs a) {
  hier_query<kW, kOutRows>(a);
}

// K9m: the median of K9's rows.
template <int kW>
__global__ void __launch_bounds__(kQueryThreads)
    sk_hier_query_signed_median_kernel(const __grid_constant__ QueryArgs a) {
  hier_query<kW, kOutMedian>(a);
}

using QueryKernel = void (*)(const QueryArgs);

template <int kOut, int kW, typename T>
QueryKernel query_kernel() {
  if constexpr (kOut == kOutMin && std::is_same<T, float>::value) {
    return sk_hier_query_f32_kernel<kW>;
  } else if constexpr (kOut == kOutMin) {
    return sk_hier_query_kernel<kW>;
  } else if constexpr (kOut == kOutRows) {
    return sk_hier_query_signed_kernel<kW>;
  } else {
    return sk_hier_query_signed_median_kernel<kW>;
  }
}

// make(std::integral_constant<int, kW>{}) with kW = w for w = 1 to
// kUnrolledRows (the unrolled instances), else kW = 0 (the runtime loop).
template <typename Make>
auto by_rows(int w, Make make) {
  static_assert(kUnrolledRows == 8, "one case a row count below");
  switch (w) {
    case 1: return make(std::integral_constant<int, 1>{});
    case 2: return make(std::integral_constant<int, 2>{});
    case 3: return make(std::integral_constant<int, 3>{});
    case 4: return make(std::integral_constant<int, 4>{});
    case 5: return make(std::integral_constant<int, 5>{});
    case 6: return make(std::integral_constant<int, 6>{});
    case 7: return make(std::integral_constant<int, 7>{});
    case 8: return make(std::integral_constant<int, 8>{});
    default: return make(std::integral_constant<int, 0>{});
  }
}

template <int kOut, typename T>
QueryKernel query_kernel_for(int w) {
  return by_rows(w, [](auto kw) { return query_kernel<kOut, decltype(kw)::value, T>(); });
}

// Launches K4 (T int32), K4f (T float), K9 or K9m on the caller's stream.  `span` > 0 is the window
// route (`smem` then w staged rows and the barrier), 0 the direct route
// (`smem` 0); a launch whose shared bytes, tile or grid disagree is refused,
// as is one whose shared bytes the card cannot grant.
template <int kOut, typename T = int32_t>
int launch_hier_query(QueryArgs a, int64_t smem, void* stream) {
  if (a.P <= 0 || a.C <= 0) return 0;
  a.pitch = a.span > 0 ? window_pitch(a.span) : 0;
  const int64_t want = a.span > 0 ? 4 * (int64_t)a.w * a.pitch + kBarBytes : 0;
  a.c_tiles = a.c_tile > 0 ? (a.C + a.c_tile - 1) / a.c_tile : 0;
  if (a.w <= 0 || a.span < 0 || a.span > INT_MAX || smem != want || a.c_tile <= 0 ||
      a.P * a.c_tiles > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const QueryKernel kernel = query_kernel_for<kOut, T>(a.w);
  const int rc = sk_fold::opt_in_smem(kernel, (size_t)smem);
  if (rc) return rc;
  kernel<<<(unsigned)(a.P * a.c_tiles), kQueryThreads, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sk_query
