// Hand-written Hopper kernels for the conservative (Estan-Varghese) fold,
// K5 and K5i, with a plain C interface for ctypes.  Built with the other
// sources by repro_torch/kernels/_cuda.py.
//
// One conservative step for item b with frequency f is
//
//     cur_k = table[k, idx_k(b)]               for every row k
//     est   = min_k cur_k + f
//     table[k, idx_k(b)] = max(cur_k, est)
//
// The min couples the w rows of one item, and item b+1 reads item b's writes
// (duplicate keys inside a block are the common case on a skewed stream), so
// the fold is a dependent chain in stream order.  It cannot be reordered or
// split across blocks of threads the way the linear atomics are.
//
// Design (right and simple; not fast).  One CTA folds one table, a chunk of
// items at a time.  First the whole CTA stages the chunk's cell indices
// (hashed by K5, read by K5i) and frequencies in shared memory; then one warp
// folds the chunk: lane k owns row k (rows k, k+32, ... when w > 32), loads
// its cell, the warp takes the minimum, and the lane stores max(cur, min + f).
// Each lane reads only cells it wrote itself, so program order is the only
// ordering the chain needs.  The next item's staged index and frequency are
// read one step ahead, so each step waits on one dependent table load plus
// the warp minimum, and on no load of keys or indices from global memory.
//
// Residency, in place of the TPU kernel's 14 MiB VMEM budget: when the table
// (w x cols cells) fits one CTA's dynamic shared memory beside the staging
// buffers, the CTA copies it in, folds it there, and writes it back once;
// otherwise the warp folds in global memory (L2 / HBM).  Both routes run the
// same fold body.  The route and the chunk length are chosen by the Python
// wrapper (kernels/sketch_update_conservative.residency, index_chunk).  The global route keeps no
// read-only cache path: the table is neither const __restrict__ nor read with
// __ldg, since a non-coherent load after the thread's own store is undefined.
//
// Arithmetic is exact in both table types: int32 adds in uint32 and casts
// back, which wraps as jnp's int32 add does (and then max(cur, est) = cur);
// float32 adds with __fadd_rn, one rounding as in jnp.  NaN never enters:
// the wrappers' callers refuse negative and NaN frequencies
// (core/sketch.check_conservative_freqs).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "hashes.cuh"

// Mirrored field for field by repro_torch/kernels/_cuda.py (ctypes): the
// tables of one K5i launch, table l folded by CTA l.
struct ConsLevelsC {
  int32_t n_levels;
  int32_t w;                              // rows, the same for every table
  void* tables[SK_MAX_LEVELS];            // int32 or float32, as the launch
  const int64_t* idx[SK_MAX_LEVELS];      // int64 [w, B], contiguous
  int64_t row_stride[SK_MAX_LEVELS];      // elements between rows
  int64_t cols[SK_MAX_LEVELS];            // cells per row (the shared copy)
  int32_t shared[SK_MAX_LEVELS];          // 1: fold in shared memory
};

namespace {

constexpr int kThreads = 256;   // the CTA that copies a shared-route table
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct ConsOps;

template <>
struct ConsOps<int32_t> {
  static __device__ __forceinline__ int32_t top() { return INT_MAX; }
  static __device__ __forceinline__ int32_t warp_min(int32_t v) {
    return __reduce_min_sync(kFull, v);
  }
  static __device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
};

template <>
struct ConsOps<float> {
  static __device__ __forceinline__ float top() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float warp_min(float v) {
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
    return v;
  }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

// The fold of items [0, n) into `tbl` (rows `row_stride` apart), run by one
// whole warp.  `cell(k, b)` is row k's cell of item b.  Shared by K5 (which
// hashes) and K5i (which reads given indices), and by both residency routes.
template <typename T, typename CellFn>
__device__ void fold_items(T* tbl, int64_t row_stride, int w,
                           const T* __restrict__ freqs, int64_t n, CellFn cell) {
  using Ops = ConsOps<T>;
  const int lane = threadIdx.x & 31;
  if (n <= 0) return;
  if (w <= 32) {
    const bool own = lane < w;
    T* row = tbl + (int64_t)(own ? lane : 0) * row_stride;
    int64_t next_cell = own ? cell(lane, 0) : 0;
    T next_f = freqs[0];
    for (int64_t b = 0; b < n; ++b) {
      const int64_t c = next_cell;
      const T f = next_f;
      if (b + 1 < n) {
        next_cell = own ? cell(lane, b + 1) : 0;
        next_f = freqs[b + 1];
      }
      const T cur = own ? row[c] : Ops::top();
      const T est = Ops::add(Ops::warp_min(cur), f);
      if (own) row[c] = cur > est ? cur : est;
    }
    return;
  }
  // w > 32: a lane owns several rows; the second pass reloads its own cells,
  // which nothing else wrote in between.
  for (int64_t b = 0; b < n; ++b) {
    T m = Ops::top();
    for (int k = lane; k < w; k += 32) {
      const T cur = tbl[(int64_t)k * row_stride + cell(k, b)];
      m = cur < m ? cur : m;
    }
    const T est = Ops::add(Ops::warp_min(m), freqs[b]);
    for (int k = lane; k < w; k += 32) {
      T* p = tbl + (int64_t)k * row_stride + cell(k, b);
      const T cur = *p;
      *p = cur > est ? cur : est;
    }
  }
}

// Shared memory of one CTA: the table when it is resident, then the staging
// buffers of one chunk, int32 cell indices [w, chunk] and frequencies [chunk].
template <typename T>
__host__ __device__ size_t fold_smem_bytes(int w, int64_t cols, int chunk, bool shared) {
  return (shared ? (size_t)w * (size_t)cols * sizeof(T) : 0) +
         (size_t)chunk * ((size_t)w * sizeof(int32_t) + sizeof(T));
}

// Either route: copy in (shared), then per chunk stage with the whole CTA and
// fold with warp 0, then copy back (shared).
template <typename T, typename CellFn>
__device__ void fold_resident(T* table, int64_t row_stride, int64_t cols, int w,
                              bool shared, const T* __restrict__ freqs, int64_t n,
                              int chunk, CellFn cell) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  T* s_tab = reinterpret_cast<T*>(sk_smem);
  int32_t* s_idx = reinterpret_cast<int32_t*>(s_tab + (shared ? (int64_t)w * cols : 0));
  T* s_f = reinterpret_cast<T*>(s_idx + (int64_t)w * chunk);
  if (shared) {
    for (int k = 0; k < w; ++k)
      for (int64_t c = threadIdx.x; c < cols; c += blockDim.x)
        s_tab[k * cols + c] = table[k * row_stride + c];
  }
  T* tbl = shared ? s_tab : table;
  const int64_t stride = shared ? cols : row_stride;
  auto staged = [=](int k, int64_t b) -> int64_t { return s_idx[(int64_t)k * chunk + b]; };
  for (int64_t base = 0; base < n; base += chunk) {
    const int cnt = (int)(n - base < chunk ? n - base : chunk);
    __syncthreads();  // the copy-in, or the previous chunk's fold, is done
    for (int i = threadIdx.x; i < cnt * w; i += blockDim.x) {
      const int k = i / cnt, b = i - k * cnt;
      s_idx[(int64_t)k * chunk + b] = (int32_t)cell(k, base + b);
    }
    for (int b = threadIdx.x; b < cnt; b += blockDim.x) s_f[b] = freqs[base + b];
    __syncthreads();
    if (threadIdx.x < 32) fold_items(tbl, stride, w, s_f, cnt, staged);
  }
  if (shared) {
    __syncthreads();
    for (int k = 0; k < w; ++k)
      for (int64_t c = threadIdx.x; c < cols; c += blockDim.x)
        table[k * row_stride + c] = s_tab[k * cols + c];
  }
}

// K5 replaces src/repro/kernels/sketch_update_conservative.py
// `sketch_update_conservative_pallas` (`_conservative_kernel`, and the
// residency rule `conservative_chunk_b`).  One CTA; its threads hash each
// chunk's (row, item) cells with composite_index (K0) into shared memory.
// Bound: the chain, B dependent steps of one table load and a warp minimum;
// the bytes (keys, frequencies, the touched cells) are a few microseconds.
template <typename T>
__global__ void sk_conservative_update_kernel(const __grid_constant__ IndexPlanC plan,
                                              T* table, int64_t h_pad, int32_t w,
                                              const int64_t* __restrict__ chunks,
                                              const T* __restrict__ freqs, int64_t n,
                                              const int64_t* __restrict__ q,
                                              const int64_t* __restrict__ r, int32_t shared,
                                              int32_t chunk) {
  const IndexPlanC* p = &plan;
  auto cell = [=](int k, int64_t b) -> int64_t {
    return composite_index(*p, chunks + b * p->total_chunks, q + (int64_t)k * p->total_chunks,
                           r + (int64_t)k * p->n_groups);
  };
  fold_resident(table, h_pad, h_pad, w, shared != 0, freqs, n, chunk, cell);
}

// K5i: the same fold on given indices (int64 [w, B] per table), every table
// of a hierarchy in one launch, one CTA per table (levels are independent).
// It is the counterpart of the reference's jnp fold (core/sketch.py
// `conservative_fold`, core/hierarchy.py `_update_conservative_tables_jit`),
// which no Pallas kernel computes.  Bound: as K5, the chain of each table.
template <typename T>
__global__ void sk_conservative_fold_kernel(const __grid_constant__ ConsLevelsC lv,
                                            const T* __restrict__ freqs, int64_t n,
                                            int32_t chunk) {
  const int l = blockIdx.x;
  T* table = reinterpret_cast<T*>(lv.tables[l]);
  const int64_t* __restrict__ idx = lv.idx[l];
  auto cell = [=](int k, int64_t b) -> int64_t { return idx[(int64_t)k * n + b]; };
  fold_resident(table, lv.row_stride[l], lv.cols[l], lv.w, lv.shared[l] != 0, freqs, n,
                chunk, cell);
}

// Not a port of any TPU kernel: a probe that measures the chain K5 and K5i
// walk, for the chain bound chip_smoke.py reports beside their bytes bound.
// One warp takes `steps` dependent steps, each one table load whose address
// depends on the previous step's warp minimum, then the warp minimum
// (__reduce_min_sync), over `next` (a permutation of [0, n)) in shared
// memory or in global memory.  out[0] gets the last minimum, so nothing is
// optimised away.
__global__ void sk_chain_probe_kernel(const int32_t* next, int64_t n, int64_t steps,
                                      int32_t shared, int32_t* out) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  const int32_t* t = next;
  if (shared) {
    int32_t* s = reinterpret_cast<int32_t*>(sk_smem);
    for (int64_t c = threadIdx.x; c < n; c += blockDim.x) s[c] = next[c];
    __syncthreads();
    t = s;
  }
  if (threadIdx.x >= 32) return;
  int64_t p = (int64_t)threadIdx.x * (n / 32);
  int32_t m = 0;
  for (int64_t i = 0; i < steps; ++i) {
    const int32_t v = t[p];
    m = __reduce_min_sync(kFull, v);
    p = v + (m & 1);
    if (p >= n) p -= n;
  }
  if (threadIdx.x == 0) out[0] = m;
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in first; a
// refused attribute (like a refused launch) is returned, never swallowed.
template <typename K>
int opt_in_smem(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int conservative_update(const IndexPlanC* plan, T* table, int64_t h_pad, int32_t w,
                        const int64_t* chunks, const T* freqs, int64_t n, const int64_t* q,
                        const int64_t* r, int32_t shared, int32_t chunk, void* stream) {
  if (n <= 0) return 0;
  const size_t smem = fold_smem_bytes<T>(w, h_pad, chunk, shared != 0);
  const int rc = opt_in_smem(sk_conservative_update_kernel<T>, smem);
  if (rc) return rc;
  sk_conservative_update_kernel<T><<<1, kThreads, smem, (cudaStream_t)stream>>>(
      *plan, table, h_pad, w, chunks, freqs, n, q, r, shared, chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int conservative_fold(const ConsLevelsC* levels, const T* freqs, int64_t n, int32_t chunk,
                      void* stream) {
  if (n <= 0 || levels->n_levels <= 0) return 0;
  size_t smem = 0;
  for (int l = 0; l < levels->n_levels; ++l) {
    const size_t bytes =
        fold_smem_bytes<T>(levels->w, levels->cols[l], chunk, levels->shared[l] != 0);
    smem = bytes > smem ? bytes : smem;
  }
  const int rc = opt_in_smem(sk_conservative_fold_kernel<T>, smem);
  if (rc) return rc;
  sk_conservative_fold_kernel<T><<<levels->n_levels, kThreads, smem, (cudaStream_t)stream>>>(
      *levels, freqs, n, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sk_conservative_update_i32(const IndexPlanC* plan, int32_t* table, int64_t h_pad, int32_t w,
                               const int64_t* chunks, const int32_t* freqs, int64_t n,
                               const int64_t* q, const int64_t* r, int32_t shared,
                               int32_t chunk, void* stream) {
  return conservative_update<int32_t>(plan, table, h_pad, w, chunks, freqs, n, q, r, shared,
                                      chunk, stream);
}

int sk_conservative_update_f32(const IndexPlanC* plan, float* table, int64_t h_pad, int32_t w,
                               const int64_t* chunks, const float* freqs, int64_t n,
                               const int64_t* q, const int64_t* r, int32_t shared,
                               int32_t chunk, void* stream) {
  return conservative_update<float>(plan, table, h_pad, w, chunks, freqs, n, q, r, shared,
                                    chunk, stream);
}

int sk_conservative_fold_i32(const ConsLevelsC* levels, const int32_t* freqs, int64_t n,
                             int32_t chunk, void* stream) {
  return conservative_fold<int32_t>(levels, freqs, n, chunk, stream);
}

int sk_chain_probe(const int32_t* next, int64_t n, int64_t steps, int32_t shared,
                   int32_t* out, void* stream) {
  const size_t smem = shared ? (size_t)n * sizeof(int32_t) : 0;
  const int rc = opt_in_smem(sk_chain_probe_kernel, smem);
  if (rc) return rc;
  sk_chain_probe_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(next, n, steps, shared,
                                                                      out);
  return (int)cudaGetLastError();
}

int sk_conservative_fold_f32(const ConsLevelsC* levels, const float* freqs, int64_t n,
                             int32_t chunk, void* stream) {
  return conservative_fold<float>(levels, freqs, n, chunk, stream);
}

}  // extern "C"
