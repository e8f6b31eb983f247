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
// The min couples the w rows of one item, and item b reads the writes of
// every earlier item that shares one of its cells, so the fold is ordered
// only along chains of items that share a cell.  Items whose w cells are
// pairwise disjoint commute.  On a skewed stream the longest such chain (the
// dependency depth) is 11 to 7,000 items of a 65,536-item block, not 65,536.
//
// Design: walk the block's dependency structure, not its length.  One CTA
// of 16 warps folds one table.
//
// * 14 producer warps stage the block, one chunk of `cap` (at most 128)
//   items per warp, into up to 16 buffers in shared memory: they hash (K5)
//   or read (K5i) each item's w cells, cut the chunk into runs (maximal runs
//   of adjacent items with identical cells; a run whose frequencies are all
//   zero changes nothing and is marked dead), and give each run of a window
//   of 32 runs its level (1 + the highest level among the window's earlier
//   runs that share a cell with it in some row), its source lane per row
//   (the latest such run on that row's cell) and its last-writer bits, all
//   from one `__match_any_sync` per row.  On the global route they also
//   prefetch the chunk's cells, and their next chunk's inputs, into L2.
//   Buffers change hands through mbarriers (full / empty), so a producer
//   waits only for its own buffer.
// * Two fold warps take the windows in turns, run j on lane j and all of its
//   w <= 8 rows in registers (the min over rows is an in-thread min).  A
//   warp reads its window's runs while the other folds the window before,
//   waits at a named barrier for that window's stores, loads its cells'
//   values once, and applies the window level by level: at its level a lane
//   takes each row's value from its source lane's slot in shared memory,
//   folds its run, and leaves its values in its own slots; the last writer of
//   each cell stores it.  Runs of one level touch pairwise disjoint cells, so
//   no atomics, and each cell still sees its writers in stream order.  A run
//   is folded in registers: m = the min of its cells, then m <- max(m, m + f)
//   over its items in stream order, then max(cur_k, m) per row.  That is the
//   per-item fold's result exactly: the adds happen one at a time in stream
//   order (float rounding), and an int32 add that wraps leaves m, as the
//   per-item fold leaves the cells.  w > 8 folds on one warp through the
//   table, level by level.
//
// The work is S level steps (the windows' depths summed; 250 to 10,600 a
// block on chip_smoke.py's stream) instead of B dependent steps.  Bound: the
// bytes, or one access to the table's memory (HBM: the table starts there on
// both routes) and then D_r dependent steps of the fold's recurrence in
// registers, whichever is larger; D_r is the depth after runs collapse
// (kernels/sketch_update_conservative.fold_depths reports D, D_r and S, and
// sk_chain_probe below measures the two latencies).
// What sets the time is each window's serial part on one warp: the handoff,
// one load of the window's cells (an L2 access on the global route), and
// about 100 dependent instructions a level.  Loading the next window's
// values before the handoff, into registers or with cp.async, and an L1
// prefetch (by the waiting warp, or two windows ahead) each made the
// global route slower on the H100 (PERF.md section 6), so the values are
// loaded after it.

// Claim rounds, K5's route for a large block on the global route (the table
// in HBM, w <= 8): the single-CTA walk above keeps 131 of the H100's 132 SMs
// idle, though a block of distinct keys is only a few items deep.  One
// cooperative launch of as many CTAs as fit on the card folds the block in
// rounds instead.  Each thread hashes up to kRoundItems items into registers
// (and their cells into L2).  In a round every pending item claims each of
// its w (row, cell) pairs with atomicMin of (round tag, item) in a claim
// table that hashes the pairs into 2^slot_bits slots; after a grid barrier,
// an item that holds all its claims folds, as the per-item step above, and
// leaves.  Items that share a cell share its slot, so of the pending items
// that share a cell only the first can fold, and the items of a round touch
// pairwise disjoint cells: each reads what the serial fold would have read.
// Two unrelated pairs that share a slot only delay the later item.  The
// folded items are closed under "an earlier item shares a cell", so when a
// round folds fewer than kTailPerCta items a CTA (the rounds' barriers then
// cost more than they fold: PERF.md section 6), the items left are listed in
// stream order and CTA 0 folds them with the window body above (the tail),
// which is the serial fold of what is left.  A block past one segment
// (2^kItemBits items, or what the grid holds) is folded segment by segment.
// The claim table (reset in every segment; the tail's list once the rounds
// end), the barrier's words and a count of the rounds live in scratch that
// the wrapper allocates once per sketch
// (kernels/sketch_update_conservative.RoundScratch).

// Residency, in place of the TPU kernel's 14 MiB VMEM budget: when the table
// (w x cols cells) fits one CTA's dynamic shared memory beside the staging
// buffers, the CTA copies it in, folds it there, and writes it back once;
// otherwise the fold warps fold in global memory (L2 / HBM).  Both routes run
// the same body.  The Python wrapper picks the route
// (kernels/sketch_update_conservative.residency, which sets aside
// staging_bytes for staging) and the items a buffer holds (buffer_items);
// the launcher lays the buffers out and takes as many as fit.  For w below
// 1,366 two buffers and the reserve fit in what the rule sets aside; above,
// a table that the rule puts in shared memory but that leaves no room for
// two buffers is folded on the global route, with the same result.  The
// global route keeps no read-only cache path: the table is neither
// const __restrict__ nor read with __ldg, since a non-coherent load after
// the warp's own store is undefined.

// Arithmetic is exact in both table types: int32 adds in uint32 and casts
// back, which wraps as jnp's int32 add does; float32 adds with __fadd_rn,
// one rounding as in jnp.  NaN never enters: the wrappers' callers refuse
// negative and NaN frequencies (core/sketch.check_conservative_freqs).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>

#include "hashes.cuh"
#include "hier_fold.cuh"

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

constexpr int kThreads = 512;              // two fold warps, then the producers
constexpr int kFoldWarps = 2;
constexpr int kProducerWarps = kThreads / 32 - kFoldWarps;
constexpr int kRegRows = 8;                // rows a fold lane keeps in registers
constexpr int kMaxCap = 0xffff;            // items a buffer may hold (16-bit run words)
constexpr int kMaxBuffers = 16;
constexpr int kRunBytes = 14;              // run word, sources, level, last-writer bits
// per CTA: the buffers' full and empty mbarriers, their run counts, and the
// fold warps' forwarding slots [kFoldWarps, kRegRows, 32] of 4-byte values
constexpr int kReserveBytes =
    2 * kMaxBuffers * 8 + kMaxBuffers * 4 + kFoldWarps * kRegRows * 32 * 4;
constexpr int kBarDone = 1;                // + fold warp: its last window is folded
constexpr size_t kSmemLimit = 232448;      // one CTA's dynamic shared memory on an H100
constexpr unsigned kFull = 0xffffffffu;
constexpr int kDead = 0xff;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.L2 [%0];" ::"l"(p));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Every lane of a warp arrives: a phase counts 32 arrivals a warp.  Returns
// the barrier's state, which the callers do not need.
__device__ __forceinline__ uint64_t mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];"
               : "=l"(state)
               : "r"(smem_addr(bar))
               : "memory");
  return state;
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

template <typename T>
struct ConsOps;

template <>
struct ConsOps<int32_t> {
  static __device__ __forceinline__ int32_t top() { return INT_MAX; }
  static __device__ __forceinline__ int32_t add(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a + (uint32_t)b);
  }
};

template <>
struct ConsOps<float> {
  static __device__ __forceinline__ float top() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

// One staging buffer in shared memory, for `cap` items; the chunk's runs are
// numbered in stream order.
template <typename T>
struct Stage {
  uint64_t* src;   // [cap] run r, byte k (k < kRegRows): the latest earlier lane of its
                   //       window that shares its row-k cell, or its own lane
  int32_t* idx;    // [w, cap] each item's cell per row
  T* f;            // [cap] frequencies
  uint32_t* run;   // [cap + 1] run r: its first item | (nonzero items before it) << 16;
                   //           entry R: the item count | the nonzero count << 16
  uint8_t* lvl;    // [cap] run r's level in its window, kDead when it changes nothing
  uint8_t* last;   // [cap] bit k: no later run of the window shares its row-k cell
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline size_t buffer_bytes(int w, int cap, size_t itemsize) {
  return round16((size_t)cap * (4 * (size_t)w + itemsize + kRunBytes) + 4);
}

template <typename T>
__device__ Stage<T> stage_at(unsigned char* p, int w, int cap) {
  Stage<T> s;
  s.src = reinterpret_cast<uint64_t*>(p);
  s.idx = reinterpret_cast<int32_t*>(s.src + cap);
  s.f = reinterpret_cast<T*>(s.idx + (int64_t)w * cap);
  s.run = reinterpret_cast<uint32_t*>(s.f + cap);
  s.lvl = reinterpret_cast<uint8_t*>(s.run + cap + 1);
  s.last = s.lvl + cap;
  return s;
}

// K5's cells: the cell index (K0) of each (row, item) from the keys'
// chunks, in hashes.cuh's fused form (the chunks' low halves in registers
// when the key has at most kRegChunks of them, `% range` as a multiply and a
// shift), one lane per item.
// kListed: position j of the fold is item order[j] (the claim rounds' tail,
// in stream order), read past L1 since other CTAs wrote the list.
template <int kChunks, bool kListed = false>
struct HashCells {
  static constexpr bool kIndirect = kListed;
  const IndexPlanC* plan;
  const HashDivsC* divs;
  const int64_t* __restrict__ chunks;   // [B, total_chunks]
  const int64_t* __restrict__ q;        // [w, total_chunks]
  const int64_t* __restrict__ r;        // [w, n_groups]
  const int32_t* order;                 // kListed: [n] items

  __device__ __forceinline__ int64_t item(int64_t j) const {
    if constexpr (kListed) return __ldcg(order + j);
    return j;
  }

  // Item b's cell per row, c[k] for k < w <= kRegRows.
  __device__ __forceinline__ void cells_of(int64_t b, int w, int32_t* c) const {
    const int nc = plan->total_chunks;
    const int64_t* x = chunks + b * nc;
    uint32_t xr[kChunks > 0 ? kChunks : 1];
    load_chunks<kChunks>(*plan, x, true, xr);
#pragma unroll
    for (int k = 0; k < kRegRows; ++k) {
      if (k < w) {
        uint32_t idx, bits;
        index_and_sign_bits<kChunks, false>(*plan, *divs, xr, x, q + (int64_t)k * nc,
                                            r + (int64_t)k * plan->n_groups, nullptr, nullptr,
                                            idx, bits);
        c[k] = (int32_t)idx;
      }
    }
  }

  template <typename T>
  __device__ void stage(const Stage<T>& st, int cap, int w, int64_t base, int cnt,
                        int lane) const {
    const int nc = plan->total_chunks;
    for (int b = lane; b < cnt; b += 32) {
      const int64_t* x = chunks + item(base + b) * nc;
      uint32_t xr[kChunks > 0 ? kChunks : 1];
      load_chunks<kChunks>(*plan, x, true, xr);
      for (int k = 0; k < w; ++k) {
        uint32_t idx, bits;
        index_and_sign_bits<kChunks, false>(*plan, *divs, xr, x, q + (int64_t)k * nc,
                                            r + (int64_t)k * plan->n_groups, nullptr, nullptr,
                                            idx, bits);
        st.idx[k * cap + b] = (int32_t)idx;
      }
    }
  }

  __device__ void prefetch(int64_t base, int cnt, int lane, int) const {
    if constexpr (kListed) return;
    const char* p = reinterpret_cast<const char*>(chunks + base * plan->total_chunks);
    const int bytes = cnt * plan->total_chunks * 8;
    for (int o = lane * 128; o < bytes; o += 32 * 128) prefetch_l2(p + o);
  }
};

// K5i's cells: given int64 indices [w, n].
struct GivenCells {
  static constexpr bool kIndirect = false;
  const int64_t* __restrict__ idx;
  int64_t n;

  __device__ __forceinline__ int64_t item(int64_t j) const { return j; }

  template <typename T>
  __device__ void stage(const Stage<T>& st, int cap, int w, int64_t base, int cnt,
                        int lane) const {
    const int total = cnt * w;
    for (int i0 = lane; i0 < total; i0 += 8 * 32) {
      int64_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {   // eight independent loads in flight
        const int i = i0 + u * 32;
        const int k = i / cnt, b = i - k * cnt;
        v[u] = i < total ? idx[(int64_t)k * n + base + b] : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * 32;
        const int k = i / cnt, b = i - k * cnt;
        if (i < total) st.idx[k * cap + b] = (int32_t)v[u];
      }
    }
  }

  __device__ void prefetch(int64_t base, int cnt, int lane, int w) const {
    const int lines = (cnt * 8 + 127) / 128 + 1;
    for (int i = lane; i < w * lines; i += 32) {
      const int k = i / lines, o = i - k * lines;
      prefetch_l2(reinterpret_cast<const char*>(idx + (int64_t)k * n + base) + o * 128);
    }
  }
};

// Run by one producer warp: stage items [base, base + cnt) into `st`, cut
// them into runs and give each window of 32 runs its levels, sources and
// last writers; `*count` gets the number of runs.  `table` (the global
// route's, else null) gets the cells prefetched into L2; `next` items on
// from `base + step` are the warp's next chunk, whose inputs go to L2 too.
template <typename T, typename Cells>
__device__ __forceinline__ void stage_chunk(const Stage<T>& st, int cap, int w,
                                            const Cells& cells, const T* __restrict__ freqs,
                                            int64_t base, int cnt, int64_t step, int next,
                                            const T* table, int64_t row_stride,
                                            int32_t* count) {
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1;
  if (!Cells::kIndirect && next > 0) {
    cells.prefetch(base + step, next, lane, w);
    const char* fp = reinterpret_cast<const char*>(freqs + base + step);
    for (int o = lane * 128; o < next * (int)sizeof(T); o += 32 * 128) prefetch_l2(fp + o);
  }
  cells.stage(st, cap, w, base, cnt, lane);
  for (int b = lane; b < cnt; b += 32) st.f[b] = freqs[cells.item(base + b)];
  __syncwarp();
  if (table != nullptr) {
    for (int i = lane; i < cnt * w; i += 32) {
      const int k = i / cnt, b = i - k * cnt;
      prefetch_l2(table + (int64_t)k * row_stride + st.idx[k * cap + b]);
    }
  }
  // runs: a head differs from the item before it in some row; the nonzero
  // frequencies before each head tell a dead run (all zero) from a live one
  int n_runs = 0, nz = 0;
  for (int g = 0; g < cnt; g += 32) {
    const int b = g + lane;
    bool head = false, live = false;
    if (b < cnt) {
      head = b == 0;
      for (int k = 0; k < w && !head; ++k) head = st.idx[k * cap + b] != st.idx[k * cap + b - 1];
      live = st.f[b] != T(0);
    }
    const unsigned hb = __ballot_sync(kFull, head), nb = __ballot_sync(kFull, live);
    if (head)
      st.run[n_runs + __popc(hb & lower)] = (uint32_t)b | (uint32_t)(nz + __popc(nb & lower)) << 16;
    n_runs += __popc(hb);
    nz += __popc(nb);
  }
  if (lane == 0) {
    st.run[n_runs] = (uint32_t)cnt | (uint32_t)nz << 16;
    *count = n_runs;
  }
  __syncwarp();
  // windows: each row's matching cells among the window's live runs give
  // the dependency mask, the source lane and the last writer; then one
  // round per level
  for (int r0 = 0; r0 < n_runs; r0 += 32) {
    const int r = r0 + lane;
    bool live = false;
    int start = 0;
    if (r < n_runs) {
      const uint32_t a = st.run[r], e = st.run[r + 1];
      start = a & 0xffff;
      live = (e >> 16) > (a >> 16);
    }
    unsigned dep = 0, last = 0;
    uint64_t src = 0;
    for (int k = 0; k < w; ++k) {
      const unsigned peers =
          __match_any_sync(kFull, live ? st.idx[k * cap + start] : -1 - lane);
      const unsigned earlier = peers & lower;
      dep |= earlier;
      if (k < kRegRows) {
        src |= (uint64_t)(earlier ? 31 - __clz(earlier) : lane) << (8 * k);
        last |= (unsigned)((peers >> lane) == 1u) << k;
      }
    }
    unsigned done = __ballot_sync(kFull, !live);
    int lvl = 0;
    for (int level = 0; done != kFull; ++level) {
      const bool ready = !(done >> lane & 1) && !(dep & ~done);
      if (ready) lvl = level;
      done |= __ballot_sync(kFull, ready);
    }
    if (r < n_runs) {
      st.lvl[r] = live ? (uint8_t)lvl : (uint8_t)kDead;
      st.src[r] = src;
      st.last[r] = (uint8_t)last;
    }
  }
  __syncwarp();
}

// A run's items [start, end) on its cells' minimum m, in stream order; f0 is
// f[start].
template <typename T>
__device__ __forceinline__ T fold_items(T m, T f0, const T* f, int start, int end) {
  T e = ConsOps<T>::add(m, f0);
  m = e > m ? e : m;
#pragma unroll 4
  for (int b = start + 1; b < end; ++b) {
    e = ConsOps<T>::add(m, f[b]);
    m = e > m ? e : m;
  }
  return m;
}

template <typename T>
__device__ __forceinline__ T min2(T a, T b) {
  return b < a ? b : a;
}

// The window of runs [r0, r0 + 32) on a fold warp, run r0 + j on lane j,
// w <= kRegRows.  The two fold warps take the block's windows in turns: a
// warp reads the window's runs and cells from the staging buffer, waits at
// the other warp's kBarDone barrier until the window before is folded (its
// stores done), loads the cells' values into registers and folds the window
// level by level.  At its level a lane takes each row's value from the slot
// of its source lane (the latest earlier run of the window on that cell,
// done at a lower level) in `fwd` [kRegRows, 32], folds its run, and leaves
// its values in its own slots; the last writer of each cell stores it.  So a
// level step reads shared memory once and never waits on the table's
// memory, and one warp's bookkeeping overlaps the other's fold.
template <typename T>
__device__ __forceinline__ void fold_window_regs(T* tbl, int64_t stride, int w,
                                                 const Stage<T>& st, int cap, int r0,
                                                 int n_runs, T* fwd, bool first, bool final) {
  const int lane = threadIdx.x & 31, me = threadIdx.x >> 5;
  const int r = r0 + lane;
  int lvl = kDead, start = 0, end = 0;
  uint64_t src = 0;
  unsigned last = 0;
  if (r < n_runs) {
    lvl = st.lvl[r];
    start = st.run[r] & 0xffff;
    end = st.run[r + 1] & 0xffff;
    src = st.src[r];
    last = st.last[r];
  }
  const bool live = lvl != kDead;
  const int depth = __reduce_max_sync(kFull, live ? lvl + 1 : 0);
  int32_t c[kRegRows];
  int from[kRegRows];
  unsigned pull = 0;
  const T f0 = live ? st.f[start] : T(0);
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) {
    c[k] = k < w && live ? st.idx[k * cap + start] : 0;
    const int s = (int)(src >> (8 * k)) & 31;
    from[k] = k * 32 + s;
    pull |= (unsigned)(k < w && s != lane) << k;
  }
  if (!first) bar_sync(kBarDone + (me ^ 1), 64);
  T cur[kRegRows];
#pragma unroll
  for (int k = 0; k < kRegRows; ++k)   // rows past w hold the top, which no min takes
    cur[k] = k < w && live ? tbl[(int64_t)k * stride + c[k]] : ConsOps<T>::top();
  for (int level = 0; level < depth; ++level) {
    if (lvl == level) {
#pragma unroll
      for (int k = 0; k < kRegRows; ++k)
        if (pull >> k & 1) cur[k] = fwd[from[k]];
      T m = min2(min2(min2(cur[0], cur[1]), min2(cur[2], cur[3])),
                 min2(min2(cur[4], cur[5]), min2(cur[6], cur[7])));
      m = fold_items(m, f0, st.f, start, end);
#pragma unroll
      for (int k = 0; k < kRegRows; ++k) {
        cur[k] = cur[k] > m ? cur[k] : m;
        if (k < w) fwd[k * 32 + lane] = cur[k];
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int k = 0; k < kRegRows; ++k)
    if (k < w && live && (last >> k & 1)) tbl[(int64_t)k * stride + c[k]] = cur[k];
  __syncwarp();
  if (!final) bar_arrive(kBarDone + me, 64);
}

// w > kRegRows: level by level through the table, each lane of a level
// loading its cells, then storing them; __syncwarp orders the levels.
template <typename T>
__device__ __forceinline__ void fold_window_table(T* tbl, int64_t stride, int w,
                                                  const Stage<T>& st, int cap, int r0,
                                                  int n_runs) {
  const int r = r0 + (threadIdx.x & 31);
  int lvl = kDead, start = 0, end = 0;
  if (r < n_runs) {
    lvl = st.lvl[r];
    start = st.run[r] & 0xffff;
    end = st.run[r + 1] & 0xffff;
  }
  const int depth = __reduce_max_sync(kFull, lvl == kDead ? 0 : lvl + 1);
  for (int level = 0; level < depth; ++level) {
    if (lvl == level) {
      T m = tbl[st.idx[start]];
      for (int k = 1; k < w; ++k) {
        const T v = tbl[(int64_t)k * stride + st.idx[k * cap + start]];
        m = v < m ? v : m;
      }
      m = fold_items(m, st.f[start], st.f, start, end);
      for (int k = 0; k < w; ++k) {
        T* p = tbl + (int64_t)k * stride + st.idx[k * cap + start];
        const T v = *p;
        *p = v > m ? v : m;
      }
    }
    __syncwarp();
  }
}

// One route: copy in (shared), the producer / fold pipeline over chunks of
// `cap` items in `n_buf` buffers, copy back (shared).  kShared makes the
// table's accesses shared-memory instructions on the shared route.  Chunk i
// is staged by producer warp kFoldWarps + i % kProducerWarps into buffer
// i % n_buf; full[b] (32 arrivals) and empty[b] (one warp's 32 for each fold
// warp) hand the buffer over.
template <typename T, bool kShared, bool kRegs, typename Cells>
__device__ __forceinline__ void fold_route(T* table, int64_t row_stride, int64_t cols, int w,
                                           const T* __restrict__ freqs, int64_t n, int cap,
                                           int n_buf, const Cells& cells) {
  extern __shared__ __align__(16) unsigned char sk_smem[];
  T* s_tab = reinterpret_cast<T*>(sk_smem);
  unsigned char* stage0 = sk_smem + (kShared ? round16((size_t)w * cols * sizeof(T)) : 0);
  const size_t bb = buffer_bytes(w, cap, sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(stage0 + n_buf * bb);
  uint64_t* empty = full + kMaxBuffers;
  int32_t* counts = reinterpret_cast<int32_t*>(empty + kMaxBuffers);
  T* fwd = reinterpret_cast<T*>(counts + kMaxBuffers);          // [kFoldWarps, kRegRows, 32]
  if (threadIdx.x == 0) {
    for (int b = 0; b < n_buf; ++b) {
      mbar_init(full + b, 32);
      mbar_init(empty + b, 32 * kFoldWarps);
    }
  }
  if (kShared) {
    for (int k = 0; k < w; ++k)
      for (int64_t c = threadIdx.x; c < cols; c += blockDim.x)
        s_tab[k * cols + c] = table[k * row_stride + c];
  }
  __syncthreads();
  T* tbl = kShared ? s_tab : table;
  const int64_t stride = kShared ? cols : row_stride;
  const int64_t n_chunks = (n + cap - 1) / cap;
  const int warp = threadIdx.x >> 5;
  if (warp < kFoldWarps) {
    // window g of the block goes to fold warp g % 2 (w > kRegRows: all to
    // warp 0, which folds through the table)
    int64_t g = 0;
    for (int64_t i = 0; i < n_chunks; ++i) {
      const int b = (int)(i % n_buf);
      mbar_wait(full + b, (uint32_t)(i / n_buf) & 1);
      const Stage<T> st = stage_at<T>(stage0 + b * bb, w, cap);
      const int n_runs = counts[b];
      for (int r0 = 0; r0 < n_runs; r0 += 32, ++g) {
        if (kRegs) {
          if ((int)(g & 1) == warp)
            fold_window_regs(tbl, stride, w, st, cap, r0, n_runs,
                             fwd + warp * kRegRows * 32, g == 0,
                             i + 1 == n_chunks && r0 + 32 >= n_runs);
        } else if (warp == 0) {
          fold_window_table(tbl, stride, w, st, cap, r0, n_runs);
        }
      }
      mbar_arrive(empty + b);
    }
  } else {
    const int64_t step = (int64_t)kProducerWarps * cap;
    for (int64_t i = warp - kFoldWarps; i < n_chunks; i += kProducerWarps) {
      const int b = (int)(i % n_buf);
      const int64_t use = i / n_buf;
      if (use > 0) mbar_wait(empty + b, (uint32_t)(use - 1) & 1);
      const int64_t base = i * cap;
      const int64_t rest = n - base - step;
      stage_chunk(stage_at<T>(stage0 + b * bb, w, cap), cap, w, cells, freqs, base,
                  (int)(n - base < cap ? n - base : cap), step,
                  (int)(rest <= 0 ? 0 : rest < cap ? rest : cap), kShared ? nullptr : table,
                  row_stride, counts + b);
      mbar_arrive(full + b);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int k = 0; k < w; ++k)
      for (int64_t c = threadIdx.x; c < cols; c += blockDim.x)
        table[k * row_stride + c] = s_tab[k * cols + c];
  }
}

template <typename T, bool kRegs, typename Cells>
__device__ void fold_table(T* table, int64_t row_stride, int64_t cols, int w, bool shared,
                           const T* __restrict__ freqs, int64_t n, int cap, int n_buf,
                           const Cells& cells) {
  if (shared)
    fold_route<T, true, kRegs>(table, row_stride, cols, w, freqs, n, cap, n_buf, cells);
  else
    fold_route<T, false, kRegs>(table, row_stride, cols, w, freqs, n, cap, n_buf, cells);
}

// ---- claim rounds (see the note at the top) ----

constexpr int kItemBits = 17;                  // a segment's item in a claim
constexpr int kRoundItems = 2;                 // items a thread holds in registers
constexpr uint32_t kTagTop = (1u << (32 - kItemBits)) - 2;   // round 0's tag; later rounds lower
constexpr int kMaxRounds = (int)kTagTop;       // a segment's rounds before its tail
constexpr uint32_t kFreeSlot = 0xffffffffu;    // above every claim
constexpr int kMaxCtas = 1024;
constexpr int kTailPerCta = 2;                 // a round folding fewer items a CTA ends the rounds
// ctl words: the barrier's arrivals (low half) and the sum it carries (high
// half) in one 64-bit word; its generation (high) and last sum (low) in
// another, which the CTAs poll, on a line of its own; from kCtlCta on, one
// word per CTA
constexpr int kCtlCount = 0, kCtlPub = 32, kCtlCta = 64;

// The launcher fills it from the wrapper's scratch (RoundScratch).
struct RoundsC {
  uint32_t* claims;   // [1 << slot_bits] claim slots; the tail's list once the rounds end
  int32_t slot_bits;
  int32_t seg;        // items a segment holds
  uint32_t* ctl;      // [kCtlCta + kMaxCtas], all zero before the sketch's first launch
  int64_t* stats;     // [4] added to: blocks, rounds, items folded in rounds, items to the tail
};

__device__ __forceinline__ unsigned long long ld_acquire64(const uint32_t* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// A barrier across the launch's CTAs (all resident: a cooperative launch)
// that sums one value per CTA.  Thread 0 of each CTA adds (its value, one
// arrival) to the count word; the last to arrive clears it and publishes
// (generation + 1, sum) with a release store, which the others poll for.
// So the count is zero again when the launch ends.  `gen`, thread 0's, is
// the generation it last saw.
__device__ uint32_t grid_sum(uint32_t* ctl, uint32_t mine, uint32_t& gen) {
  __shared__ uint32_t total;
  __syncthreads();
  if (threadIdx.x == 0) {
    auto* count = reinterpret_cast<unsigned long long*>(ctl + kCtlCount);
    __threadfence();
    const unsigned long long old = atomicAdd(count, (unsigned long long)mine << 32 | 1ull);
    uint32_t sum;
    if ((uint32_t)old == gridDim.x - 1) {
      sum = (uint32_t)(old >> 32) + mine;
      atomicExch(count, 0ull);
      __threadfence();
      const unsigned long long pub = (unsigned long long)(gen + 1) << 32 | sum;
      asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(ctl + kCtlPub), "l"(pub)
                   : "memory");
    } else {
      unsigned long long pub;
      do {
        pub = ld_acquire64(ctl + kCtlPub);
      } while ((uint32_t)(pub >> 32) == gen);
      sum = (uint32_t)pub;
    }
    __threadfence();
    ++gen;
    total = sum;
  }
  __syncthreads();
  return total;
}

// The claim slot of row k's cell: the top slot_bits bits of a Fibonacci hash
// (kernels/sketch_update_conservative.claim_slots is its plain twin).
__device__ __forceinline__ uint32_t claim_slot(int k, int32_t cell, int slot_bits) {
  const uint64_t key = (uint64_t)k << 32 | (uint32_t)cell;
  return (uint32_t)((key * 0x9E3779B97F4A7C15ull) >> (64 - slot_bits));
}

// One item's conservative step on its cells c[k] (k < w), as the per-item
// fold: est = min_k cur_k + f, each cell raised to est.  Reads past L1: other
// CTAs wrote the cells in earlier rounds.
template <typename T>
__device__ __forceinline__ void fold_claimed(T* table, int64_t stride, int w, const int32_t* c,
                                             T f) {
  T cur[kRegRows];
  T m = ConsOps<T>::top();
#pragma unroll
  for (int k = 0; k < kRegRows; ++k) {
    if (k < w) {
      cur[k] = __ldcg(table + (int64_t)k * stride + c[k]);
      m = min2(m, cur[k]);
    }
  }
  const T est = ConsOps<T>::add(m, f);
#pragma unroll
  for (int k = 0; k < kRegRows; ++k)
    if (k < w && est > cur[k]) table[(int64_t)k * stride + c[k]] = est;
}

// Each flagged item's rank among the CTA's flagged items in stream order
// (item u of thread t at u * blockDim.x + t); returns how many are flagged.
__device__ __forceinline__ uint32_t cta_ranks(const bool* flag, uint32_t* rank) {
  __shared__ uint32_t counts[kRoundItems][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned ballot[kRoundItems];
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kRoundItems; ++u) {
    ballot[u] = __ballot_sync(kFull, flag[u]);
    if (lane == 0) counts[u][warp] = __popc(ballot[u]);
  }
  __syncthreads();
  uint32_t total = 0;
#pragma unroll
  for (int u = 0; u < kRoundItems; ++u) {
    for (int v = 0; v < kThreads / 32; ++v) {
      if (v == warp) rank[u] = total + __popc(ballot[u] & ((1u << lane) - 1));
      total += counts[u][v];
    }
  }
  return total;
}

// The sum of the per-CTA words of the CTAs before this one.
__device__ __forceinline__ uint32_t ctas_before(const uint32_t* ctl) {
  __shared__ uint32_t before;
  if (threadIdx.x < 32) {
    uint32_t s = 0;
    for (uint32_t c = threadIdx.x; c < blockIdx.x; c += 32) s += __ldcg(ctl + kCtlCta + c);
    s = __reduce_add_sync(kFull, s);
    if (threadIdx.x == 0) before = s;
  }
  __syncthreads();
  return before;
}

template <typename T, int kChunks>
__device__ void fold_in_rounds(const IndexPlanC& plan, const HashDivsC& divs, T* table,
                               int64_t h_pad, int w, const int64_t* __restrict__ chunks,
                               const T* __restrict__ freqs, int64_t n,
                               const int64_t* __restrict__ q, const int64_t* __restrict__ r,
                               int cap, int n_buf, const RoundsC& rs) {
  const HashCells<kChunks> cells{&plan, &divs, chunks, q, r, nullptr};
  const uint32_t n_ctas = gridDim.x;
  const int bits = rs.slot_bits;
  uint32_t gen = threadIdx.x == 0 ? (uint32_t)(ld_acquire64(rs.ctl + kCtlPub) >> 32) : 0;
  int64_t rounds = 0, in_rounds = 0, in_tail = 0;
  for (int64_t s0 = 0; s0 < n; s0 += rs.seg) {
    const int seg = (int)(n - s0 < rs.seg ? n - s0 : rs.seg);
    const int per = (seg + (int)n_ctas - 1) / (int)n_ctas;
    const int lo = (int)blockIdx.x * per, hi = seg < lo + per ? seg : lo + per;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < (int64_t)1 << bits;
         i += (int64_t)n_ctas * blockDim.x)
      rs.claims[i] = kFreeSlot;
    // hash: item u of this thread is the segment's item at[u]; zero
    // frequencies change nothing and take no part
    int32_t c[kRoundItems][kRegRows];
    uint32_t at[kRoundItems];
    T f[kRoundItems];
    bool pend[kRoundItems];
    uint32_t mine = 0;
#pragma unroll
    for (int u = 0; u < kRoundItems; ++u) {
      at[u] = (uint32_t)(lo + u * (int)blockDim.x + (int)threadIdx.x);
      f[u] = (int)at[u] < hi ? freqs[s0 + at[u]] : T(0);
      pend[u] = f[u] != T(0);
      if (pend[u]) {
        cells.cells_of(s0 + at[u], w, c[u]);
#pragma unroll
        for (int k = 0; k < kRegRows; ++k)
          if (k < w) prefetch_l2(table + (int64_t)k * h_pad + c[u][k]);
      }
      mine += __syncthreads_count(pend[u]);
    }
    uint32_t pending = grid_sum(rs.ctl, mine, gen);
    bool tail = false;
    for (int round = 0; pending > 0; ++round) {
      const uint32_t tag = (kTagTop - (uint32_t)round) << kItemBits;
#pragma unroll
      for (int u = 0; u < kRoundItems; ++u) {
        if (pend[u]) {
#pragma unroll
          for (int k = 0; k < kRegRows; ++k)
            if (k < w) atomicMin(rs.claims + claim_slot(k, c[u][k], bits), tag | at[u]);
        }
      }
      grid_sum(rs.ctl, 0, gen);
      mine = 0;
#pragma unroll
      for (int u = 0; u < kRoundItems; ++u) {
        bool won = pend[u];
        if (won) {
#pragma unroll
          for (int k = 0; k < kRegRows; ++k)
            if (k < w) won &= __ldcg(rs.claims + claim_slot(k, c[u][k], bits)) == (tag | at[u]);
        }
        if (won) {
          fold_claimed(table, h_pad, w, c[u], f[u]);
          pend[u] = false;
        }
        mine += __syncthreads_count(won);
      }
      const uint32_t folded = grid_sum(rs.ctl, mine, gen);
      pending -= folded;
      in_rounds += folded;
      ++rounds;
      if (pending > 0 && (folded < kTailPerCta * n_ctas || round + 1 == kMaxRounds)) {
        tail = true;
        break;
      }
    }
    if (!tail) continue;
    // the tail: the items left, listed in stream order over the claim table,
    // folded by CTA 0's window body
    uint32_t rank[kRoundItems];
    const uint32_t left = cta_ranks(pend, rank);
    if (threadIdx.x == 0) atomicExch(rs.ctl + kCtlCta + blockIdx.x, left);
    grid_sum(rs.ctl, 0, gen);
    const uint32_t before = ctas_before(rs.ctl);
#pragma unroll
    for (int u = 0; u < kRoundItems; ++u)
      if (pend[u]) rs.claims[before + rank[u]] = (uint32_t)(s0 + at[u]);
    grid_sum(rs.ctl, 0, gen);
    if (blockIdx.x == 0) {
      const HashCells<kChunks, true> listed{&plan, &divs, chunks, q, r,
                                            reinterpret_cast<const int32_t*>(rs.claims)};
      fold_route<T, false, true>(table, h_pad, h_pad, w, freqs, (int64_t)pending, cap, n_buf,
                                 listed);
    }
    in_tail += pending;
    if (s0 + seg < n)   // the next segment resets the claims, which hold the list
      grid_sum(rs.ctl, 0, gen);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    rs.stats[0] += 1;
    rs.stats[1] += rounds;
    rs.stats[2] += in_rounds;
    rs.stats[3] += in_tail;
  }
}

// Shared memory of one launch: the largest resident table (rounded to 16
// bytes), `n_buf` staging buffers of `cap` items and the reserve.  The
// buffers take what the table leaves of one CTA's limit, 2 to kMaxBuffers
// of them.
inline size_t fold_smem_bytes(int w, size_t table_bytes, int cap, size_t itemsize, int n_buf) {
  return round16(table_bytes) + n_buf * buffer_bytes(w, cap, itemsize) + kReserveBytes;
}

inline bool leaves_two_buffers(int w, size_t table_bytes, int cap, size_t itemsize) {
  return fold_smem_bytes(w, table_bytes, cap, itemsize, 2) <= kSmemLimit;
}

inline int buffers_for(int w, size_t table_bytes, int cap, size_t itemsize) {
  const size_t used = fold_smem_bytes(w, table_bytes, cap, itemsize, 0);
  const size_t n = used < kSmemLimit ? (kSmemLimit - used) / buffer_bytes(w, cap, itemsize) : 0;
  return n < 2 ? 2 : n > kMaxBuffers ? kMaxBuffers : (int)n;
}

// K5 replaces src/repro/kernels/sketch_update_conservative.py
// `sketch_update_conservative_pallas` (`_conservative_kernel`, and the
// residency rule `conservative_chunk_b`).  One CTA; its producers hash each
// chunk's (row, item) cells into shared memory.
// kRounds: the claim rounds on every CTA of a cooperative launch, the
// tail on CTA 0 (global route, kRegs).
template <typename T, int kChunks, bool kRegs, bool kRounds>
__global__ void __launch_bounds__(kThreads)
    sk_conservative_update_kernel(const __grid_constant__ IndexPlanC plan,
                                  const __grid_constant__ HashDivsC divs, T* table,
                                  int64_t h_pad, int32_t w, const int64_t* __restrict__ chunks,
                                  const T* __restrict__ freqs, int64_t n,
                                  const int64_t* __restrict__ q, const int64_t* __restrict__ r,
                                  int32_t shared, int32_t cap, int32_t n_buf,
                                  const __grid_constant__ RoundsC rounds) {
  if constexpr (kRounds) {
    fold_in_rounds<T, kChunks>(plan, divs, table, h_pad, w, chunks, freqs, n, q, r, cap, n_buf,
                               rounds);
  } else {
    const HashCells<kChunks> cells{&plan, &divs, chunks, q, r, nullptr};
    fold_table<T, kRegs>(table, h_pad, h_pad, w, shared != 0, freqs, n, cap, n_buf, cells);
  }
}

// K5i: the same fold on given indices (int64 [w, B] per table), every table
// of a hierarchy in one launch, one CTA per table (levels are independent).
// It is the counterpart of the reference's jnp fold (core/sketch.py
// `conservative_fold`, core/hierarchy.py `_update_conservative_tables_jit`),
// which no Pallas kernel computes.  Bound: as K5, each table's D_r.
template <typename T, bool kRegs>
__global__ void __launch_bounds__(kThreads)
    sk_conservative_fold_kernel(const __grid_constant__ ConsLevelsC lv,
                                const T* __restrict__ freqs, int64_t n, int32_t cap,
                                int32_t n_buf) {
  const int l = blockIdx.x;
  const GivenCells cells{lv.idx[l], n};
  fold_table<T, kRegs>(reinterpret_cast<T*>(lv.tables[l]), lv.row_stride[l], lv.cols[l], lv.w,
                       lv.shared[l] != 0, freqs, n, cap, n_buf, cells);
}

// Not a port of any TPU kernel: a probe of the two latencies of the depth
// bound chip_smoke.py reports beside the bytes bound.  One thread takes
// `steps` dependent steps.  With `chase` set, each step is one load whose
// address is the last load's value, over `next` (one cycle through [0, n))
// in global memory: an access to the table's memory.  Otherwise each step
// is the fold's recurrence m <- max(m, m + f) on int32 in registers, the
// least that one step of a chain of runs does (no memory, no warp
// operation).  out[0] gets the last value, so nothing is optimised away.
__global__ void sk_chain_probe_kernel(const int32_t* next, int64_t n, int64_t steps,
                                      int32_t chase, int32_t* out) {
  if (threadIdx.x != 0) return;
  int32_t m = next[0];
  if (chase) {
    for (int64_t i = 0; i < steps; ++i) m = next[m];
  } else {
    const int32_t f = next[n - 1];
    for (int64_t i = 0; i < steps; ++i) {
      const int32_t e = ConsOps<int32_t>::add(m, f);
      m = e > m ? e : m;
    }
  }
  out[0] = m;
}

// Dynamic shared memory above 48 KB: the opt-in shared with the hierarchy
// folds (hier_fold.cuh), granted once per kernel and device.
using sk_fold::opt_in_smem;

template <typename T>
int conservative_update(const IndexPlanC* plan, T* table, int64_t h_pad, int32_t w,
                        const int64_t* chunks, const T* freqs, int64_t n, const int64_t* q,
                        const int64_t* r, int32_t shared, int32_t cap, void* stream) {
  if (n <= 0) return 0;
  if (cap < 1 || cap > kMaxCap || w < 1) return (int)cudaErrorInvalidValue;
  if (shared && !leaves_two_buffers(w, (size_t)w * h_pad * sizeof(T), cap, sizeof(T))) shared = 0;
  const size_t table_bytes = shared ? (size_t)w * h_pad * sizeof(T) : 0;
  const int n_buf = buffers_for(w, table_bytes, cap, sizeof(T));
  const size_t smem = fold_smem_bytes(w, table_bytes, cap, sizeof(T), n_buf);
  const bool regs = w <= kRegRows, in_regs = chunks_in_registers(*plan);
  auto kernel = regs ? (in_regs ? sk_conservative_update_kernel<T, kRegChunks, true, false>
                                : sk_conservative_update_kernel<T, 0, true, false>)
                     : (in_regs ? sk_conservative_update_kernel<T, kRegChunks, false, false>
                                : sk_conservative_update_kernel<T, 0, false, false>);
  const int rc = opt_in_smem(kernel, smem);
  if (rc) return rc;
  kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(*plan, make_hash_divs(*plan), table, h_pad,
                                                      w, chunks, freqs, n, q, r, shared, cap,
                                                      n_buf, RoundsC{});
  return (int)cudaGetLastError();
}

// The claim rounds' launch: its kernel, shared memory, CTAs (as many as fit
// on the card, at most kMaxCtas) and segment (items).
template <typename T>
struct RoundsLaunch {
  decltype(&sk_conservative_update_kernel<T, 0, true, true>) kernel;
  int n_buf;
  size_t smem;
  int ctas;
  int seg;
};

// The CTAs of a rounds launch, found once per kernel instance, shared memory
// and device (the occupancy query is not free on the host).
struct GridSize {
  const void* kernel;
  int device;
  size_t smem;
  int ctas;
};
constexpr int kMaxGridSizes = 32;
std::mutex grid_lock;
GridSize grid_sizes[kMaxGridSizes];
int n_grid_sizes = 0;

template <typename K>
int resident_ctas(K kernel, size_t smem, int* ctas) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(grid_lock);
  for (int i = 0; i < n_grid_sizes; ++i) {
    const GridSize& g = grid_sizes[i];
    if (g.kernel == (const void*)kernel && g.device == device && g.smem == smem) {
      *ctas = g.ctas;
      return 0;
    }
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *ctas = per_sm * sms < kMaxCtas ? per_sm * sms : kMaxCtas;
  if (n_grid_sizes < kMaxGridSizes)
    grid_sizes[n_grid_sizes++] = {(const void*)kernel, device, smem, *ctas};
  return 0;
}

template <typename T>
int rounds_launch(const IndexPlanC* plan, int32_t w, int32_t cap, RoundsLaunch<T>* out) {
  if (cap < 1 || cap > kMaxCap || w < 1 || w > kRegRows) return (int)cudaErrorInvalidValue;
  out->kernel = chunks_in_registers(*plan) ? sk_conservative_update_kernel<T, kRegChunks, true, true>
                                           : sk_conservative_update_kernel<T, 0, true, true>;
  out->n_buf = buffers_for(w, 0, cap, sizeof(T));
  out->smem = fold_smem_bytes(w, 0, cap, sizeof(T), out->n_buf);
  int rc = opt_in_smem(out->kernel, out->smem);
  if (!rc) rc = resident_ctas(out->kernel, out->smem, &out->ctas);
  if (rc) return rc;
  const int64_t held = (int64_t)out->ctas * kThreads * kRoundItems;
  out->seg = (int)(held < (1 << kItemBits) ? held : 1 << kItemBits);
  return 0;
}

template <typename T>
int conservative_rounds(const IndexPlanC* plan, T* table, int64_t h_pad, int32_t w,
                        const int64_t* chunks, const T* freqs, int64_t n, const int64_t* q,
                        const int64_t* r, int32_t cap, uint32_t* claims, int32_t slot_bits,
                        uint32_t* ctl, int64_t* stats, void* stream) {
  if (n <= 0) return 0;
  if (slot_bits < kItemBits || slot_bits > 30) return (int)cudaErrorInvalidValue;
  RoundsLaunch<T> L{};
  const int rc = rounds_launch<T>(plan, w, cap, &L);
  if (rc) return rc;
  IndexPlanC p = *plan;
  HashDivsC divs = make_hash_divs(*plan);
  int32_t shared = 0;
  RoundsC rs{claims, slot_bits, L.seg, ctl, stats};
  void* args[] = {&p, &divs, &table, &h_pad, &w, &chunks, &freqs, &n, &q, &r, &shared, &cap,
                  &L.n_buf, &rs};
  return (int)cudaLaunchCooperativeKernel((const void*)L.kernel, dim3(L.ctas), dim3(kThreads),
                                          args, L.smem, (cudaStream_t)stream);
}

template <typename T>
int conservative_fold(const ConsLevelsC* levels, const T* freqs, int64_t n, int32_t cap,
                      void* stream) {
  if (n <= 0 || levels->n_levels <= 0) return 0;
  ConsLevelsC lv = *levels;
  const int w = lv.w;
  if (cap < 1 || cap > kMaxCap || w < 1) return (int)cudaErrorInvalidValue;
  size_t table_bytes = 0;
  for (int l = 0; l < lv.n_levels; ++l) {
    const size_t bytes = (size_t)w * lv.cols[l] * sizeof(T);
    if (lv.shared[l] && !leaves_two_buffers(w, bytes, cap, sizeof(T))) lv.shared[l] = 0;
    if (lv.shared[l] && bytes > table_bytes) table_bytes = bytes;
  }
  const int n_buf = buffers_for(w, table_bytes, cap, sizeof(T));
  const size_t smem = fold_smem_bytes(w, table_bytes, cap, sizeof(T), n_buf);
  auto kernel = w <= kRegRows ? sk_conservative_fold_kernel<T, true>
                              : sk_conservative_fold_kernel<T, false>;
  const int rc = opt_in_smem(kernel, smem);
  if (rc) return rc;
  kernel<<<lv.n_levels, kThreads, smem, (cudaStream_t)stream>>>(lv, freqs, n, cap, n_buf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sk_conservative_update_i32(const IndexPlanC* plan, int32_t* table, int64_t h_pad, int32_t w,
                               const int64_t* chunks, const int32_t* freqs, int64_t n,
                               const int64_t* q, const int64_t* r, int32_t shared,
                               int32_t cap, void* stream) {
  return conservative_update<int32_t>(plan, table, h_pad, w, chunks, freqs, n, q, r, shared,
                                      cap, stream);
}

int sk_conservative_update_f32(const IndexPlanC* plan, float* table, int64_t h_pad, int32_t w,
                               const int64_t* chunks, const float* freqs, int64_t n,
                               const int64_t* q, const int64_t* r, int32_t shared,
                               int32_t cap, void* stream) {
  return conservative_update<float>(plan, table, h_pad, w, chunks, freqs, n, q, r, shared,
                                    cap, stream);
}

int sk_conservative_rounds_i32(const IndexPlanC* plan, int32_t* table, int64_t h_pad, int32_t w,
                               const int64_t* chunks, const int32_t* freqs, int64_t n,
                               const int64_t* q, const int64_t* r, int32_t cap,
                               uint32_t* claims, int32_t slot_bits, uint32_t* ctl,
                               int64_t* stats, void* stream) {
  return conservative_rounds<int32_t>(plan, table, h_pad, w, chunks, freqs, n, q, r, cap, claims,
                                      slot_bits, ctl, stats, stream);
}

int sk_conservative_rounds_f32(const IndexPlanC* plan, float* table, int64_t h_pad, int32_t w,
                               const int64_t* chunks, const float* freqs, int64_t n,
                               const int64_t* q, const int64_t* r, int32_t cap,
                               uint32_t* claims, int32_t slot_bits, uint32_t* ctl,
                               int64_t* stats, void* stream) {
  return conservative_rounds<float>(plan, table, h_pad, w, chunks, freqs, n, q, r, cap, claims,
                                    slot_bits, ctl, stats, stream);
}

// The claim rounds' schedule for this plan, rows, buffer and table type on
// the current device (the plain model's `min_fold` and `seg`): the fewest
// items a round folds without ending the rounds, and the segment's items.
int sk_conservative_rounds_grid(const IndexPlanC* plan, int32_t w, int32_t cap, int32_t f32,
                                int32_t* min_fold, int32_t* seg) {
  int rc;
  if (f32) {
    RoundsLaunch<float> L{};
    rc = rounds_launch<float>(plan, w, cap, &L);
    *min_fold = kTailPerCta * L.ctas;
    *seg = L.seg;
  } else {
    RoundsLaunch<int32_t> L{};
    rc = rounds_launch<int32_t>(plan, w, cap, &L);
    *min_fold = kTailPerCta * L.ctas;
    *seg = L.seg;
  }
  return rc;
}

int sk_conservative_fold_i32(const ConsLevelsC* levels, const int32_t* freqs, int64_t n,
                             int32_t cap, void* stream) {
  return conservative_fold<int32_t>(levels, freqs, n, cap, stream);
}

int sk_chain_probe(const int32_t* next, int64_t n, int64_t steps, int32_t chase,
                   int32_t* out, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  sk_chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(next, n, steps, chase, out);
  return (int)cudaGetLastError();
}

int sk_conservative_fold_f32(const ConsLevelsC* levels, const float* freqs, int64_t n,
                             int32_t cap, void* stream) {
  return conservative_fold<float>(levels, freqs, n, cap, stream);
}

}  // extern "C"
