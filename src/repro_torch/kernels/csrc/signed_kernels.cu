// Hand-written Hopper kernels for the signed (Count-Sketch) path (K6-K9, K7m,
// K9m, K6f, K8f), with a plain C interface for ctypes.  K8's body, shared
// with K3, lives in hier_fold.cuh; K9's and K9m's, shared with K4, in
// hier_query.cuh; K7's and K7m's, shared with K2, in point_query.cuh.
// Built beside sketch_kernels.cu into
// one shared library by repro_torch/kernels/_cuda.py:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler -fPIC \
//        -c signed_kernels.cu
//
// Every launcher launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() for the Python wrapper
// to raise on.
//
// What the TPU kernels did and what is left of it here: the Pallas signed
// kernels multiply the +-1 sign into 12-bit frequency limbs before a one-hot
// f32 matmul on the MXU, and gather through 16-bit table limbs.  None of
// that carries over.  The sign is one bit of the packed parities
// (K0s, computed beside the cell by hashes.cuh's index_and_sign_bits),
// applied to an int32 value in two's complement;
// an int32 atomicAdd is exact and two's-complement addition associative, so
// any order of atomics gives the jnp scatter's table, wraparound included.
// K7 and K9 write the signed rows, as the reference's kernels do; K7m, the
// flat sketch's query, and K9m, the descent's, take the median over rows in
// registers (point_query.cuh, hier_query.cuh).
//
// The folds K6 and K8 are templates on the table type.  On int32 tables the
// frequencies are int32 of either sign.  On float32 tables (K6f, K8f: the
// reference's `_update_kernel_signed_f32` and `_hier_kernel_signed_f32`
// bodies, which fold the gradient compressor's sketches) the values are
// float32, the sign an exact negation as the reference's s * v, and the add
// a float atomicAdd: any order of them equals the plain version bit for bit
// while every cell's partial sums are integers below 2^24, and agrees within
// float32 rounding otherwise (the reference's contract, hier_update.py:35-38).
// K7, K7m, K9 and K9m read int32 tables only, as the reference's query
// kernels do.
//
// Indices, chunks and hash params are int64 (the port's index dtype); sign
// partials float32 +-1.

#include <cuda_runtime.h>

#include <cstdint>

#include "hashes.cuh"
#include "hier_fold.cuh"
#include "hier_query.cuh"
#include "point_query.cuh"

namespace {

constexpr int kThreads = 256;

// K6 / K6f: the signed flat fold.  K6 replaces src/repro/kernels/
// sketch_update.py `sketch_update_signed_pallas` (`_update_kernel_signed_int`;
// as K6f, `_update_kernel_signed_f32`): table[k, idx_k(b)] += s_k(b) * f_b,
// the flat sign s_k being bit n_groups - 1 of the packed sign bits.
//
// The first design ran one thread per (row, key), gridDim.y = w: a key's
// chunks, value and params were read once per row, w times, as 64-bit
// values; the cell and the sign were two Carter-Wegman passes
// (the cell's and the sign's) of 64 x 64-bit products, each group
// ending in a 32-bit division by a runtime range.  On the turnstile block
// (65,536 keys, w = 4, a [4, 4096^2] int32 table of 268 MB) it took 0.02335
// ms with L2 evicted, 1.010x `index_add_` of the same signed values
// (chip_smoke.py on an H100 80GB HBM3 at 700 W).  That work, which the
// hierarchy folds shed, turned out hidden here: the atomics bounded the
// first design as they bound this one (below).
//
// The design: K8's, without the levels (hier_fold.cuh).  One thread per key
// runs all w rows: the key's value is read once and its chunks once (their
// low halves, in registers when the key has at most kRegChunks of them,
// else from the chunk array each row), the cell and the sign come from one
// pass of hashes.cuh's fused index_and_sign_bits, and each thread has w
// independent global atomics in flight.  A zero value skips the hash and the
// adds; a warp whose keys are all zero leaves at once.
//
// The grid is one CTA per kThreads keys, with no span walk.  hier_fold's
// walk deals spans of consecutive keys to a CTA so that it meets runs of keys
// that share a coarse cell; the flat cell is the whole key's hash, so keys
// meet only by collision and consecutive keys share nothing.  At 65,536 keys
// that is 256 CTAs of 256 threads (39 registers), which the 132 SMs hold at
// once, so a walk would only serialise keys.  For the same reason there is
// no warp combine (__match_any_sync on the cell): on the turnstile block it
// would save 15 of the 262,144 adds (chip_smoke.py, `bound_probes`
// `warp_combinable_adds`), and a match costs every lane every row.
//
// What bounds it: the random read-modify-writes, which `index_add_` pays
// too.  On the turnstile block, H100 80GB HBM3 at 700 W (chip_smoke.py's
// K6 row and its probes): 0.02296 ms with L2 evicted, 0.98x `index_add_`;
// the same keys into a 16 MB table, 0.01674 ms with L2 evicted and 0.01340
// with the table read into L2 first; all-zero values, which skip the hash
// and the atomics, 0.00569.  Halving the integer work and reading each key
// once left the device time where the first design had it (0.01971 ms
// against 0.01953): the hash is hidden behind the atomics, and 58% of the
// time stays when the table sits in L2.
template <typename T, int kChunks>
__global__ void __launch_bounds__(kThreads)
    sk_update_signed_kernel(const __grid_constant__ IndexPlanC plan,
                            const __grid_constant__ HashDivsC divs, T* __restrict__ table,
                            int64_t h_pad, int32_t w, const int64_t* __restrict__ chunks,
                            const T* __restrict__ freqs, int64_t n,
                            const int64_t* __restrict__ q, const int64_t* __restrict__ r,
                            const int64_t* __restrict__ sq, const int64_t* __restrict__ sr) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const T f = b < n ? freqs[b] : T(0);
  if (f == T(0)) return;
  const int64_t* x = chunks + b * plan.total_chunks;
  uint32_t xr[kChunks > 0 ? kChunks : 1];
  load_chunks<kChunks>(plan, x, true, xr);
  const int top = plan.n_groups - 1;
  for (int k = 0; k < w; ++k) {
    uint32_t idx, bits;
    index_and_sign_bits<kChunks, true>(plan, divs, xr, x, q + k * plan.total_chunks,
                                       r + k * plan.n_groups, sq + k * plan.total_chunks,
                                       sr + k * plan.n_groups, idx, bits);
    atomicAdd(table + k * h_pad + idx, sk_apply_sign(f, (bits >> top) & 1u));
  }
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <typename T>
int launch_update_signed(const IndexPlanC* plan, T* table, int64_t h_pad, int32_t w,
                         const int64_t* chunks, const T* freqs, int64_t n, const int64_t* q,
                         const int64_t* r, const int64_t* sq, const int64_t* sr,
                         void* stream) {
  if (n <= 0) return 0;
  auto kernel = chunks_in_registers(*plan) ? sk_update_signed_kernel<T, kRegChunks>
                                           : sk_update_signed_kernel<T, 0>;
  kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      *plan, make_hash_divs(*plan), table, h_pad, w, chunks, freqs, n, q, r, sq, sr);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sk_sketch_update_signed(const IndexPlanC* plan, int32_t* table, int64_t h_pad, int32_t w,
                            const int64_t* chunks, const int32_t* freqs, int64_t n,
                            const int64_t* q, const int64_t* r, const int64_t* sq,
                            const int64_t* sr, void* stream) {
  return launch_update_signed(plan, table, h_pad, w, chunks, freqs, n, q, r, sq, sr, stream);
}

int sk_sketch_update_signed_f32(const IndexPlanC* plan, float* table, int64_t h_pad,
                                int32_t w, const int64_t* chunks, const float* freqs,
                                int64_t n, const int64_t* q, const int64_t* r,
                                const int64_t* sq, const int64_t* sr, void* stream) {
  return launch_update_signed(plan, table, h_pad, w, chunks, freqs, n, q, r, sq, sr, stream);
}

// K7 and K7m: point_query.cuh's body, the signed rows and their median.
int sk_sketch_query_signed(const IndexPlanC* plan, const int32_t* table, int64_t h_pad,
                           int32_t w, const int64_t* chunks, int64_t n, const int64_t* q,
                           const int64_t* r, const int64_t* sq, const int64_t* sr,
                           int32_t* out, int32_t lanes, void* stream) {
  const sk_query::PointArgs a{table, h_pad, w, chunks, n, q, r, sq, sr, out};
  return sk_query::launch_point_query<sk_query::kOutRows>(*plan, a, lanes, stream);
}

int sk_sketch_query_signed_median(const IndexPlanC* plan, const int32_t* table,
                                  int64_t h_pad, int32_t w, const int64_t* chunks, int64_t n,
                                  const int64_t* q, const int64_t* r, const int64_t* sq,
                                  const int64_t* sr, float* out, int32_t lanes,
                                  void* stream) {
  const sk_query::PointArgs a{table, h_pad, w, chunks, n, q, r, sq, sr, out};
  return sk_query::launch_point_query<sk_query::kOutMedian>(*plan, a, lanes, stream);
}

int sk_hier_update_signed(const IndexPlanC* plan, const LevelsC* levels, int32_t* table,
                          int64_t cols, int32_t w, const int64_t* chunks,
                          const int32_t* freqs, int64_t n, const int64_t* q,
                          const int64_t* r, const int64_t* sq, const int64_t* sr,
                          uint32_t shared_mask, int32_t ctas, int64_t span_tiles,
                          int64_t smem, void* stream) {
  return sk_fold::launch_hier_fold<int32_t, true>(plan, levels, table, cols, w, chunks, freqs,
                                                  n, q, r, sq, sr, shared_mask, ctas,
                                                  span_tiles, smem, stream);
}

int sk_hier_update_signed_f32(const IndexPlanC* plan, const LevelsC* levels, float* table,
                              int64_t cols, int32_t w, const int64_t* chunks,
                              const float* freqs, int64_t n, const int64_t* q,
                              const int64_t* r, const int64_t* sq, const int64_t* sr,
                              uint32_t shared_mask, int32_t ctas, int64_t span_tiles,
                              int64_t smem, void* stream) {
  return sk_fold::launch_hier_fold<float, true>(plan, levels, table, cols, w, chunks, freqs,
                                                n, q, r, sq, sr, shared_mask, ctas, span_tiles,
                                                smem, stream);
}

int sk_hier_query_signed(const int32_t* table, int64_t row_stride, int64_t cols, int32_t w,
                         const int64_t* pp, const float* sp, int64_t P, const int64_t* cp,
                         const float* sc, int64_t C, int64_t span, int64_t c_tile,
                         int64_t smem, int32_t* out, void* stream) {
  const sk_query::QueryArgs a{table, row_stride, cols, w, pp, sp, P, cp, sc, C,
                              span, 0, c_tile, 0, out};
  return sk_query::launch_hier_query<sk_query::kOutRows>(a, smem, stream);
}

int sk_hier_query_signed_median(const int32_t* table, int64_t row_stride, int64_t cols,
                                int32_t w, const int64_t* pp, const float* sp, int64_t P,
                                const int64_t* cp, const float* sc, int64_t C, int64_t span,
                                int64_t c_tile, int64_t smem, float* out, void* stream) {
  const sk_query::QueryArgs a{table, row_stride, cols, w, pp, sp, P, cp, sc, C,
                              span, 0, c_tile, 0, out};
  return sk_query::launch_hier_query<sk_query::kOutMedian>(a, smem, stream);
}

}  // extern "C"
