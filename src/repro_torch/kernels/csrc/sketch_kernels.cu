// Hand-written Hopper kernels for the sketch hot path (K1-K4, K1f, K3f, K4f), with a plain C
// interface for ctypes.  Build:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libsketch_kernels.so sketch_kernels.cu
//
// (repro_torch/kernels/_cuda.py does this at first use.)  Every launcher
// launches on the caller's stream, does not synchronise, allocates nothing,
// and returns cudaGetLastError() for the Python wrapper to raise on.
//
// What the TPU kernels did and what is left of it here: the Pallas kernels
// turn scatters and gathers into one-hot f32 matmuls on the MXU, split
// frequencies into 12-bit limbs and table values into 16-bit limbs so those
// matmuls stay exact, and accumulate across a sequential grid.  None of that
// carries over.  On Hopper an int32 atomicAdd and an int32 load are exact,
// and two's-complement addition is associative, so any order of atomics gives
// the table the jnp scatter gives, wraparound included.
//
// The folds K1 and K3 run one body on int32 and float32 tables: int32 tables
// take int32 frequencies and int32 atomics; float32 tables (K1f, K3f: the
// reference's `_update_kernel_f32` and `_hier_kernel_f32` bodies) take
// float32 values and float atomics.  That body, shared with the signed fold
// K8, lives in hier_fold.cuh (`sk_hier_update_kernel`); K1 is its one-level
// case.  A float atomicAdd rounds like the jnp scatter's adds but in another
// order, so float32 tables equal the plain version bit for bit only while
// every cell's partial sums are exact (integers below 2^24), the reference's
// own contract (hier_update.py:35-38).  K2 and K4 read int32 tables only, as
// the reference's query kernels do, and K4f, K4's body on float32 cells, the
// decayed window's float32 tables; K4's body is hier_query.cuh's, K2's
// point_query.cuh's.
//
// Indices, chunks and hash params are int64 (the port's index dtype).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hashes.cuh"
#include "hier_fold.cuh"
#include "hier_query.cuh"
#include "point_query.cuh"

namespace {

// K1 replaces src/repro/kernels/sketch_update.py `sketch_update_pallas`
// (`_update_kernel_int`; as K1f, `_update_kernel_f32`): table[k, idx_k(b)] +=
// f_b.  A flat sketch is a hierarchy of one level -- offset 0, divisor 1,
// h_pad columns -- so K1 and K1f launch hier_fold.cuh's body with that one
// level (launch_flat_fold below, the body's kFlat instance
// sk_flat_update_kernel): `ctas` CTAs for each row k (gridDim.y = w), each
// walking spans of consecutive tiles of the block, hashing row k of each
// key with the fused hash and adding with one global atomic.  Divisor 1 is
// make_divisor's m = 2^31, s = 31, so the level division would return
// every index below 2^31 unchanged; the instance skips it.
//
// What bounds it: latency and the random atomics, as the first design (one
// thread per (row, key), gridDim.y = w, a 64-bit hash, one global atomic
// each) was bounded.  Into the flat path's [4, 2^24] table a block is
// 262,144 random atomics over a table larger than L2; into the accuracy
// path's [5, 4,096] tables 327,680 atomics land on 20,480 cells, and a
// sorted stream's run of one source, which shares its 62-66 cells of a row
// (mod-sketch, equal-sketch), queues its adds on a few L2 addresses.  A
// private copy of the row per CTA would turn those into one atomic a CTA,
// but on count-min's uniform keys (16 a cell of a row) it lost to global
// atomics, and which blocks are skewed is not known at launch (PERF.md,
// open questions).
//
// Why not K3's layout, one thread per key over all w rows: a block of
// 65,536 keys then has 65,536 threads, each w dependent hashes long, and at
// K1's shapes the kernel is latency-bound.  It ran 0.7-23% slower than the
// first design (tools/fold_ab.py, H100 80GB HBM3 at 700 W: count-min at
// [5, 4,096] +13-14%, the flat path's block 7 +11%).  A CTA a row gives the
// first design's parallelism; the launch bounds ask for its registers (32
// a thread, eight CTAs an SM), and a thread reads its key's chunks where
// the hash uses them (kChunks 0: staging them in registers for one row
// cost a median 4%).
//
// K6 (signed_kernels.cu) stays a kernel of its own: its flat sign is bit
// n_groups - 1 of the packed sign bits, where this body's one level would
// read bit 0.
//
// `ctas` and `span_tiles` are kernels/sketch_update.py `flat_deal`'s;
// launch_hier_fold refuses either below 1.
template <typename T>
int launch_flat_fold(const IndexPlanC* plan, T* table, int64_t h_pad, int32_t w,
                     const int64_t* chunks, const T* freqs, int64_t n, const int64_t* q,
                     const int64_t* r, int32_t ctas, int64_t span_tiles, void* stream) {
  LevelsC one{};
  one.n_levels = 1;
  one.divs[0] = 1;
  one.offsets[0] = 0;
  return sk_fold::launch_hier_fold<T, false, true>(plan, &one, table, h_pad, w, chunks, freqs,
                                                   n, q, r, nullptr, nullptr, 0u, ctas,
                                                   span_tiles, 0, stream);
}

}  // namespace

extern "C" {

int sk_sketch_update(const IndexPlanC* plan, int32_t* table, int64_t h_pad, int32_t w,
                     const int64_t* chunks, const int32_t* freqs, int64_t n,
                     const int64_t* q, const int64_t* r, int32_t ctas, int64_t span_tiles,
                     void* stream) {
  return launch_flat_fold(plan, table, h_pad, w, chunks, freqs, n, q, r, ctas, span_tiles,
                          stream);
}

int sk_sketch_update_f32(const IndexPlanC* plan, float* table, int64_t h_pad, int32_t w,
                         const int64_t* chunks, const float* freqs, int64_t n,
                         const int64_t* q, const int64_t* r, int32_t ctas, int64_t span_tiles,
                         void* stream) {
  return launch_flat_fold(plan, table, h_pad, w, chunks, freqs, n, q, r, ctas, span_tiles,
                          stream);
}

// K2: point_query.cuh's body, the minimum over rows.
int sk_sketch_query(const IndexPlanC* plan, const int32_t* table, int64_t h_pad, int32_t w,
                    const int64_t* chunks, int64_t n, const int64_t* q, const int64_t* r,
                    int32_t* out, int32_t lanes, void* stream) {
  const sk_query::PointArgs a{table, h_pad, w, chunks, n, q, r, nullptr, nullptr, out};
  return sk_query::launch_point_query<sk_query::kOutMin>(*plan, a, lanes, stream);
}

int sk_hier_update(const IndexPlanC* plan, const LevelsC* levels, int32_t* table, int64_t cols,
                   int32_t w, const int64_t* chunks, const int32_t* freqs, int64_t n,
                   const int64_t* q, const int64_t* r, uint32_t shared_mask, int32_t ctas,
                   int64_t span_tiles, int64_t smem, void* stream) {
  return sk_fold::launch_hier_fold<int32_t, false>(plan, levels, table, cols, w, chunks, freqs,
                                                   n, q, r, nullptr, nullptr, shared_mask,
                                                   ctas, span_tiles, smem, stream);
}

int sk_hier_update_f32(const IndexPlanC* plan, const LevelsC* levels, float* table,
                       int64_t cols, int32_t w, const int64_t* chunks, const float* freqs,
                       int64_t n, const int64_t* q, const int64_t* r, uint32_t shared_mask,
                       int32_t ctas, int64_t span_tiles, int64_t smem, void* stream) {
  return sk_fold::launch_hier_fold<float, false>(plan, levels, table, cols, w, chunks, freqs, n,
                                                 q, r, nullptr, nullptr, shared_mask, ctas,
                                                 span_tiles, smem, stream);
}

int sk_hier_query(const int32_t* table, int64_t row_stride, int64_t cols, int32_t w,
                  const int64_t* pp, int64_t P, const int64_t* cp, int64_t C, int64_t span,
                  int64_t c_tile, int64_t smem, int32_t* out, void* stream) {
  const sk_query::QueryArgs a{table, row_stride, cols, w, pp, nullptr, P, cp, nullptr, C,
                              span, 0, c_tile, 0, out};
  return sk_query::launch_hier_query<sk_query::kOutMin>(a, smem, stream);
}

// K4f: K4's body on float32 tables (the decayed window's).
int sk_hier_query_f32(const float* table, int64_t row_stride, int64_t cols, int32_t w,
                      const int64_t* pp, int64_t P, const int64_t* cp, int64_t C, int64_t span,
                      int64_t c_tile, int64_t smem, float* out, void* stream) {
  const sk_query::QueryArgs a{table, row_stride, cols, w, pp, nullptr, P, cp, nullptr, C,
                              span, 0, c_tile, 0, out};
  return sk_query::launch_hier_query<sk_query::kOutMin, float>(a, smem, stream);
}

}  // extern "C"
