// Hand-written Hopper kernels for the sketch hot path (K1-K4, K1f, K3f), with a plain C
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
// The folds K1 and K3 are templates on the table type: int32 tables take int32
// frequencies and int32 atomics; float32 tables (K1f, K3f: the reference's
// `_update_kernel_f32` and `_hier_kernel_f32` bodies) take float32 values and
// float atomics.  K3's body, shared with the signed fold K8, lives in
// hier_fold.cuh (`sk_hier_update_kernel`).  A float atomicAdd rounds like the
// jnp scatter's adds but in another order, so float32 tables equal the plain
// version bit for bit only while every cell's partial sums are exact
// (integers below 2^24), the reference's own contract (hier_update.py:35-38).
// K2 and K4 read int32 tables only, as the reference's query kernels do.
//
// Indices, chunks and hash params are int64 (the port's index dtype).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hashes.cuh"
#include "hier_fold.cuh"
#include "hier_query.cuh"

namespace {

constexpr int kThreads = 256;

// K1 replaces src/repro/kernels/sketch_update.py `sketch_update_pallas`
// (`_update_kernel_int`; as K1f, `_update_kernel_f32`).  table[k, idx_k(b)] +=
// f_b, one thread per (row k, key b): gridDim.y = w rows, x over keys.
// Bound: random 4-byte read-modify-writes into a table larger than L2 (w x h
// cells); the hash is a few dozen integer operations per (row, key).  The
// design hashes once per (row, key) and adds with one atomic; zero-frequency
// pad rows skip it.
template <typename T>
__global__ void sk_update_kernel(const __grid_constant__ IndexPlanC plan,
                                 T* __restrict__ table, int64_t h_pad,
                                 const int64_t* __restrict__ chunks,
                                 const T* __restrict__ freqs, int64_t n,
                                 const int64_t* __restrict__ q,
                                 const int64_t* __restrict__ r) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t k = blockIdx.y;
  if (b >= n) return;
  const T f = freqs[b];
  if (f == T(0)) return;
  const uint32_t idx = composite_index(plan, chunks + b * plan.total_chunks,
                                       q + k * plan.total_chunks, r + k * plan.n_groups);
  atomicAdd(table + k * h_pad + idx, f);
}

// K2 replaces src/repro/kernels/sketch_query.py `sketch_query_pallas`
// (`_query_kernel`).  out[b] = min_k table[k, idx_k(b)], one thread per query.
// Bound: w random 4-byte reads per query from a table larger than L2.  The
// design keeps the row minimum in a register, so the [w, Q] per-row estimates
// the TPU kernel wrote out never reach memory.
__global__ void sk_query_kernel(const __grid_constant__ IndexPlanC plan,
                                const int32_t* __restrict__ table, int64_t h_pad,
                                int32_t w, const int64_t* __restrict__ chunks, int64_t n,
                                const int64_t* __restrict__ q,
                                const int64_t* __restrict__ r,
                                int32_t* __restrict__ out) {
  const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  const int64_t* x = chunks + b * plan.total_chunks;
  int32_t best = INT_MAX;
  for (int64_t k = 0; k < w; ++k) {
    const uint32_t idx = composite_index(plan, x, q + k * plan.total_chunks,
                                         r + k * plan.n_groups);
    best = min(best, table[k * h_pad + idx]);
  }
  out[b] = best;
}

unsigned blocks_for(int64_t n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <typename T>
int launch_update(const IndexPlanC* plan, T* table, int64_t h_pad, int32_t w,
                  const int64_t* chunks, const T* freqs, int64_t n, const int64_t* q,
                  const int64_t* r, void* stream) {
  if (n <= 0) return 0;
  dim3 grid(blocks_for(n), (unsigned)w);
  sk_update_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(*plan, table, h_pad,
                                                                   chunks, freqs, n, q, r);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sk_sketch_update(const IndexPlanC* plan, int32_t* table, int64_t h_pad, int32_t w,
                     const int64_t* chunks, const int32_t* freqs, int64_t n,
                     const int64_t* q, const int64_t* r, void* stream) {
  return launch_update(plan, table, h_pad, w, chunks, freqs, n, q, r, stream);
}

int sk_sketch_update_f32(const IndexPlanC* plan, float* table, int64_t h_pad, int32_t w,
                         const int64_t* chunks, const float* freqs, int64_t n,
                         const int64_t* q, const int64_t* r, void* stream) {
  return launch_update(plan, table, h_pad, w, chunks, freqs, n, q, r, stream);
}

int sk_sketch_query(const IndexPlanC* plan, const int32_t* table, int64_t h_pad, int32_t w,
                    const int64_t* chunks, int64_t n, const int64_t* q, const int64_t* r,
                    int32_t* out, void* stream) {
  if (n <= 0) return 0;
  sk_query_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(*plan, table, h_pad, w,
                                                                        chunks, n, q, r, out);
  return (int)cudaGetLastError();
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

}  // extern "C"
