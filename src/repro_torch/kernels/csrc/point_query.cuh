// The flat point queries, one body for K2 (the Count-Min minimum), K7 (the
// signed rows) and K7m (K7 with the median over rows fused into the launch),
// and their launcher.  Included by sketch_kernels.cu (K2) and
// signed_kernels.cu (K7, K7m).
//
// K2 replaces src/repro/kernels/sketch_query.py `sketch_query_pallas`
// (`_query_kernel`): out[b] = min_k table[k, idx_k(b)].  K7 replaces
// `sketch_query_signed_pallas` (`_query_kernel_signed`): out[k, b] =
// table[k, idx_k(b)] * s_k(b), the flat sign s_k being bit n_groups - 1 of
// the packed sign bits, as K6 adds it.  K7m is K7 and the median over rows
// the reference's KernelSketch.query takes after it
// (src/repro/kernels/ops.py:211).
//
// The first design, as chip_smoke.py measured it on an H100 80GB HBM3 at
// 700 W (65,536 queries into a [4, 2^24] int32 table of 268 MB, L2
// evicted): K2 ran one thread per query over its rows in a loop of runtime
// trip count, each row's 64-bit hash re-reading the key's int64 chunks;
// its compiled loop (cuobjdump -sass) waited on each row's cell load and
// took the minimum before hashing the next row: 17.73 us cold, 13.45 on
// the device.  K7 ran one thread per (row, query), gridDim.y = w, each
// hashing the cell and the sign in two passes over the key's chunks, and
// wrote int32 [w, Q] (1 MB) for torch's median_rows to take the median of
// in 16 more kernels (36 us of device time together).
//
// The design: a query's rows on `kLanes` consecutive lanes of a warp, one
// lane a query or one a row (kernels/sketch_query.py `point_lanes`: the
// most lanes that keep the launch within two CTAs an SM).  A lane reads
// the key's chunks once, into registers when the key has at most
// kRegChunks of them (hashes.cuh's load_chunks; longer keys read them from
// the chunk array each row, as the folds do), takes each of its rows' cell
// and sign from one pass of the fused index_and_sign_bits, and issues the
// row's cell load before it hashes its next row, so a lane's loads are in
// flight together.  The query's first lane gathers the kW (1 to 8) cells
// by warp shuffles and emits them through hier_query.cuh's `emit` on a grid
// of one prefix and Q candidates, so the minimum (K2), the rows' layout
// [w, Q] (K7) and the median's network and rounding (K7m) are the code K4,
// K9 and K9m run.  Wider w takes a runtime loop, one lane a query (K7m:
// the order statistics by rank, median_by_rank).
//
// What bounds it (tools/query_ab.py --point and chip_smoke.py, same card):
// at 65,536 queries into [4, 2^24], 13.4-13.6 us on the device, the first
// design's time; the same keys into a 16 MB table take 13.6-13.9 us cold
// with L2 evicted and 12.6-13.3 with the table in L2, against 17.4-17.5
// into the 268 MB table, so the random cell loads are not what sets it,
// and the sector bound (8.39 MB of 32-byte sectors, 2.10 MB of int64
// chunks: 2.8 us) is far below.  At the accuracy path's 500 queries into
// [5, 4,096], eight lanes a query take 2.8-3.1 us against the first
// design's 6.7-8.5: there a lane's chain of dependent hash steps is the
// time, and one row a lane cuts it w-fold.  K7m at 65,536 queries,
// 13.8-14.2 us, replaces K7 then median_rows' 36 us of device time and 16
// launches.
//
// The signed product wraps in int32, as the reference's kernel multiplies,
// so K7's rows and K7m's median equal their plain versions bit for bit on
// every int32 table; a cell of -2^31 under sign -1 is the one place where
// they differ from the reference's float32 oracle (ROADMAP's stated
// differences).  No int32 value casts to -0.0 or NaN.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hashes.cuh"
#include "hier_query.cuh"

namespace sk_query {
namespace {

struct PointArgs {
  const int32_t* table;   // [w, h_pad]
  int64_t h_pad;
  int32_t w;
  const int64_t* chunks;  // [n, total_chunks]
  int64_t n;
  const int64_t* q;       // [w, total_chunks] bucket params
  const int64_t* r;       // [w, n_groups]
  const int64_t* sq;      // [w, total_chunks] sign params (K7, K7m)
  const int64_t* sr;      // [w, n_groups]
  void* out;              // int32 [n] (K2), int32 [w, n] (K7), float [n] (K7m)
};

// Row k's cell of the key whose chunks are xr (kChunks > 0) or x, and its
// flat sign, +-1 (1 for K2).
template <int kChunks, int kOut>
__device__ __forceinline__ void point_cell(const IndexPlanC& plan, const HashDivsC& divs,
                                           const PointArgs& a, const uint32_t* xr,
                                           const int64_t* x, int k, uint32_t& idx,
                                           int32_t& s) {
  constexpr bool kSigned = kOut != kOutMin;
  const int64_t tc = plan.total_chunks, ng = plan.n_groups;
  uint32_t bits;
  index_and_sign_bits<kChunks, kSigned>(plan, divs, xr, x, a.q + k * tc, a.r + k * ng,
                                        kSigned ? a.sq + k * tc : nullptr,
                                        kSigned ? a.sr + k * ng : nullptr, idx, bits);
  s = 1 - 2 * (int32_t)((bits >> (ng - 1)) & 1u);
}

// The most lanes a query may take: w rounded up to a power of two, for the
// unrolled rows (kW 1 to 8); the runtime loop takes one.
__host__ __device__ constexpr int max_lanes(int w) {
  return w < 1 || w > kUnrolledRows ? 1 : w <= 1 ? 1 : w <= 2 ? 2 : w <= 4 ? 4 : 8;
}

// The body of K2, K7 and K7m; see the top of this file.  Lane l of a query's
// kLanes (consecutive lanes of a warp) hashes and loads rows l, l + kLanes,
// ...; the query's first lane gathers the w cells by warp shuffles and
// emits.  With one lane a query a thread covers all w rows.
template <int kW, int kOut, int kChunks, int kLanes>
__device__ __forceinline__ void point_query(const IndexPlanC& plan, const HashDivsC& divs,
                                            const PointArgs& a) {
  QueryArgs grid{};   // emit's output: one prefix, the queries its candidates
  grid.P = 1;
  grid.C = a.n;
  grid.out = a.out;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (kW > 0) {
    static_assert(kLanes >= 1 && kLanes <= max_lanes(kW) && (kLanes & (kLanes - 1)) == 0,
                  "a power of two of lanes up to w's");
    constexpr int kMine = (kW + kLanes - 1) / kLanes;   // rows a lane
    const int64_t b = t / kLanes;
    const int lane = (int)(t % kLanes);
    if (kLanes == 1 && b >= a.n) return;   // no shuffle needs this lane
    const bool live = b < a.n;
    const int64_t* x = a.chunks + (live ? b : 0) * plan.total_chunks;
    uint32_t xr[kChunks > 0 ? kChunks : 1];
    load_chunks<kChunks>(plan, x, live && lane < kW, xr);
    int32_t mv[kMine], ms[kMine];
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int k = lane + i * kLanes;
      mv[i] = 0;
      ms[i] = 1;
      if (live && k < kW) {
        uint32_t idx;
        point_cell<kChunks, kOut>(plan, divs, a, xr, x, k, idx, ms[i]);
        mv[i] = __ldg(a.table + k * a.h_pad + idx);   // in flight while the next rows hash
      }
    }
    int32_t v[kW], s[kW];
#pragma unroll
    for (int k = 0; k < kW; ++k) {
      if constexpr (kLanes == 1) {
        v[k] = mv[k];
        s[k] = ms[k];
      } else {
        v[k] = __shfl_sync(0xffffffffu, mv[k / kLanes], k % kLanes, kLanes);
        s[k] = __shfl_sync(0xffffffffu, ms[k / kLanes], k % kLanes, kLanes);
      }
    }
    if (live && lane == 0) emit<kW, kOut>(grid, 0, b, v, s);
  } else {
    const int64_t b = t;
    if (b >= a.n) return;
    const int64_t* x = a.chunks + b * plan.total_chunks;
    uint32_t xr[kChunks > 0 ? kChunks : 1];
    load_chunks<kChunks>(plan, x, true, xr);
    auto value = [&](int k) {
      uint32_t idx;
      int32_t s;
      point_cell<kChunks, kOut>(plan, divs, a, xr, x, k, idx, s);
      return signed_product(__ldg(a.table + k * a.h_pad + idx), s);
    };
    if constexpr (kOut == kOutMin) {
      int32_t best = INT_MAX;
      for (int k = 0; k < a.w; ++k) best = min(best, value(k));
      static_cast<int32_t*>(a.out)[b] = best;
    } else if constexpr (kOut == kOutRows) {
      for (int k = 0; k < a.w; ++k) static_cast<int32_t*>(a.out)[k * a.n + b] = value(k);
    } else {
      static_cast<float*>(a.out)[b] =
          median_by_rank(a.w, [&](int k) { return (float)value(k); });
    }
  }
}

// K2: the Count-Min minimum over rows.
template <int kW, int kChunks, int kLanes>
__global__ void __launch_bounds__(kQueryThreads)
    sk_query_kernel(const __grid_constant__ IndexPlanC plan,
                    const __grid_constant__ HashDivsC divs, const __grid_constant__ PointArgs a) {
  point_query<kW, kOutMin, kChunks, kLanes>(plan, divs, a);
}

// K7: the signed rows.
template <int kW, int kChunks, int kLanes>
__global__ void __launch_bounds__(kQueryThreads)
    sk_query_signed_kernel(const __grid_constant__ IndexPlanC plan,
                           const __grid_constant__ HashDivsC divs,
                           const __grid_constant__ PointArgs a) {
  point_query<kW, kOutRows, kChunks, kLanes>(plan, divs, a);
}

// K7m: the median of K7's rows.
template <int kW, int kChunks, int kLanes>
__global__ void __launch_bounds__(kQueryThreads)
    sk_query_signed_median_kernel(const __grid_constant__ IndexPlanC plan,
                                  const __grid_constant__ HashDivsC divs,
                                  const __grid_constant__ PointArgs a) {
  point_query<kW, kOutMedian, kChunks, kLanes>(plan, divs, a);
}

using PointKernel = void (*)(const IndexPlanC, const HashDivsC, const PointArgs);

template <int kOut, int kW, int kChunks, int kLanes>
PointKernel point_kernel() {
  if constexpr (kLanes > max_lanes(kW)) {
    return nullptr;
  } else if constexpr (kOut == kOutMin) {
    return sk_query_kernel<kW, kChunks, kLanes>;
  } else if constexpr (kOut == kOutRows) {
    return sk_query_signed_kernel<kW, kChunks, kLanes>;
  } else {
    return sk_query_signed_median_kernel<kW, kChunks, kLanes>;
  }
}

template <int kOut, int kW, int kChunks>
PointKernel point_kernel_for_lanes(int lanes) {
  switch (lanes) {
    case 1: return point_kernel<kOut, kW, kChunks, 1>();
    case 2: return point_kernel<kOut, kW, kChunks, 2>();
    case 4: return point_kernel<kOut, kW, kChunks, 4>();
    case 8: return point_kernel<kOut, kW, kChunks, 8>();
    default: return nullptr;
  }
}

// Launches K2, K7 or K7m on the caller's stream: `lanes` threads a query
// (kernels/sketch_query.py `point_lanes`), the instance for the plan's w
// and chunk count.  A lane count that is not a power of two up to
// max_lanes(w) is refused.
template <int kOut>
int launch_point_query(const IndexPlanC& plan, const PointArgs& a, int32_t lanes,
                       void* stream) {
  if (a.n <= 0) return 0;
  if (a.w <= 0) return (int)cudaErrorInvalidValue;
  const bool regs = chunks_in_registers(plan);
  const PointKernel kernel = by_rows(a.w, [&](auto kw) {
    return regs ? point_kernel_for_lanes<kOut, decltype(kw)::value, kRegChunks>(lanes)
                : point_kernel_for_lanes<kOut, decltype(kw)::value, 0>(lanes);
  });
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int64_t threads = a.n * lanes;
  const unsigned blocks = (unsigned)((threads + kQueryThreads - 1) / kQueryThreads);
  kernel<<<blocks, kQueryThreads, 0, (cudaStream_t)stream>>>(plan, make_hash_divs(plan), a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace sk_query
