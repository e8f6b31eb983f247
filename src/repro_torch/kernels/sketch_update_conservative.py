"""K5 and K5i: the conservative (Estan-Varghese) fold, in stream order.

Port of ``repro/kernels/sketch_update_conservative.py``
(``sketch_update_conservative_pallas``).  A conservative step for item b
with frequency f is

    cur_k = table[k, idx_k(b)]            (min-gather over the w rows)
    est   = min_k cur_k + f
    table[k, idx_k(b)] = max(cur_k, est)  (max-scatter)

The min couples all w rows of one item and item b+1 reads item b's writes,
so the fold is sequential in B.  The TPU kernel keeps the whole table
resident in VMEM and walks the block as its grid; the Hopper kernels
(``csrc/conservative_kernels.cu``) fold one table per CTA, a chunk of
:func:`index_chunk` items at a time: the CTA stages the chunk's cell
indices and frequencies in shared memory, then one warp folds it, lane k
on row k.  The table itself sits in shared memory when it fits beside the
staging buffers (:func:`residency`) and in global memory otherwise.  Both
routes run the same kernel body.

* **K5** (:func:`sketch_update_conservative`) hashes each item with the
  ``composite_index`` helper (K0) and folds it into a flat [w, h_pad]
  table: the counterpart of the Pallas kernel.
* **K5i** (:func:`conservative_fold_tables`) folds given indices (int64
  [w, B] per table) into every table of a hierarchy in one launch, one CTA
  per table.  The reference computes this fold in jnp outside any Pallas
  kernel (``core/sketch.conservative_fold``,
  ``core/hierarchy._update_conservative_tables_jit``); on the card it is
  this kernel, since a Python loop over B is no option.

Tables are int32 or float32; both are exact (gather, min, add, max).  An
int32 ``min + f`` past 2^31 - 1 wraps as jnp's does, and then
``max(cur, est) = cur``.  NaN never enters: callers refuse negative and
NaN frequencies first (``core/sketch.check_conservative_freqs``), so the
plain versions do not emulate jnp's NaN propagation.  Both wrappers fold in
place (the reference donates the table) and run the plain per-item loop
only for tensors on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.hashes import IndexPlan, all_indices

# One CTA's dynamic shared memory on an H100 (227 KB), in place of the
# reference's 14 MiB VMEM budget (``_VMEM_BUDGET_BYTES``).
SHARED_BYTES = 232_448
TABLE_DTYPES = (torch.int32, torch.float32)


def index_chunk(w: int) -> int:
    """Items the kernels stage per chunk: about 16 KB of int32 cell indices
    (4,096 // w items, between 1 and 1,024)."""
    return max(1, min(1024, 4096 // w))


def staging_bytes(w: int, itemsize: int) -> int:
    """Shared memory of one chunk's staged indices [w, chunk] (int32) and
    frequencies [chunk]."""
    return index_chunk(w) * (4 * w + itemsize)


def residency(w: int, cols: int, itemsize: int,
              shared_bytes: Optional[int] = None) -> str:
    """Where a [w, cols] table is folded: ``"shared"`` when it fits one
    CTA's dynamic shared memory (``SHARED_BYTES`` unless given) beside the
    staging buffers, else ``"global"``.  The port's rule in place of
    ``conservative_chunk_b``; both answers run the kernel."""
    limit = SHARED_BYTES if shared_bytes is None else shared_bytes
    fits = w * cols * itemsize + staging_bytes(w, itemsize) <= limit
    return "shared" if fits else "global"


def conservative_fold_tables_ref(tables: Sequence[torch.Tensor],
                                 idxs: Sequence[torch.Tensor],
                                 freqs: torch.Tensor) -> Sequence[torch.Tensor]:
    """Plain version of K5i: the reference's ``fori_loop``, one item at a
    time, into each table in place.  ``freqs`` is cast to the table dtype."""
    for table, idx in zip(tables, idxs):
        w = table.shape[0]
        rows = torch.arange(w, device=table.device)
        f = freqs.to(table.dtype)
        integer = not table.dtype.is_floating_point
        for b in range(idx.shape[1]):
            cells = idx[:, b]
            cur = table[rows, cells]
            if integer:   # add in int64 and wrap back, as jnp's int32 add does
                est = (cur.min().to(torch.int64) + f[b]).to(table.dtype)
            else:
                est = cur.min() + f[b]
            table[rows, cells] = torch.maximum(cur, est)
    return tables


def sketch_update_conservative_ref(plan: IndexPlan, table: torch.Tensor,
                                   chunks: torch.Tensor, freqs: torch.Tensor,
                                   q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: hash every (row, key), then the per-item fold."""
    conservative_fold_tables_ref([table], [all_indices(plan, chunks, q, r)], freqs)
    return table


def _kernel_freqs(freqs: torch.Tensor, table: torch.Tensor, name: str,
                  b: int) -> torch.Tensor:
    """The frequencies in the table dtype, after the checks every launch
    shares: their shape, and staging buffers that fit shared memory."""
    w = table.shape[0]
    _cuda.require(staging_bytes(w, table.element_size()) <= SHARED_BYTES,
                  f"{name}: {w} rows leave no room to stage a chunk in shared memory")
    f = freqs.to(device=table.device, dtype=table.dtype).contiguous()
    _cuda.require(tuple(f.shape) == (b,),
                  f"{name}: freqs {tuple(freqs.shape)} do not match the {b} keys")
    return f


def sketch_update_conservative(plan: IndexPlan, table: torch.Tensor,
                               chunks: torch.Tensor, freqs: torch.Tensor,
                               q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Conservatively fold one block into ``table`` ([w, h_pad], int32 or
    float32) in place, in stream order; returns it.

    chunks int64[B, C], freqs [B] (non-negative, cast to the table dtype),
    q int64[w, C], r int64[w, m].  CUDA tensors launch K5 on the route
    :func:`residency` picks; CPU tensors take
    :func:`sketch_update_conservative_ref`.
    """
    if not table.is_cuda:
        return sketch_update_conservative_ref(plan, table, chunks, freqs, q, r)
    name = "sketch_update_conservative"
    _cuda.require_hash_inputs(name, plan, table, chunks, q, r, TABLE_DTYPES)
    w, h_pad = table.shape
    b = chunks.shape[0]
    _cuda.require(plan.table_size <= h_pad,
                  f"{name}: table width {h_pad} below the plan's {plan.table_size}")
    f = _kernel_freqs(freqs, table, name, b)
    shared = residency(w, h_pad, table.element_size()) == "shared"
    fn = "sk_conservative_update_" + ("i32" if table.dtype == torch.int32 else "f32")
    plan_c = _cuda.plan_struct(plan)
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = getattr(lib, fn)(
            ctypes.byref(plan_c), table.data_ptr(), h_pad, w, chunks.data_ptr(),
            f.data_ptr(), b, q.data_ptr(), r.data_ptr(), int(shared), index_chunk(w),
            _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return table


def conservative_fold_tables(tables: Sequence[torch.Tensor],
                             idxs: Sequence[torch.Tensor],
                             freqs: torch.Tensor) -> Sequence[torch.Tensor]:
    """Conservatively fold one block into every table, each at its own
    given cells, in place; returns the tables.

    tables: [w, cols_l] int32 or float32 (all one dtype and width, rows
    unit-strided, e.g. hierarchy levels); idxs: int64 [w, B] per table,
    every index below its table's ``cols``; freqs [B] (non-negative, cast
    to the table dtype).  CUDA tensors launch K5i once for all tables,
    each on the route :func:`residency` picks; CPU tensors take
    :func:`conservative_fold_tables_ref`.
    """
    tables, idxs = list(tables), list(idxs)
    if not tables:
        return tables
    if not tables[0].is_cuda:
        return conservative_fold_tables_ref(tables, idxs, freqs)
    name = "conservative_fold"
    t0 = tables[0]
    w, b = int(t0.shape[0]), int(idxs[0].shape[1])
    _cuda.require(len(tables) == len(idxs) <= _cuda.MAX_LEVELS,
                  f"{name}: one index block per table, at most "
                  f"{_cuda.MAX_LEVELS} tables")
    _cuda.require_table_dtype(t0, name, TABLE_DTYPES)
    s = _cuda.ConsLevelsC()
    s.n_levels, s.w = len(tables), w
    for l, (table, idx) in enumerate(zip(tables, idxs)):
        _cuda.require(table.dtype == t0.dtype and table.device == t0.device
                      and table.dim() == 2 and table.shape[0] == w
                      and table.stride(1) == 1 and table.shape[1] < 1 << 31,
                      f"{name}: table {l} is not a [w={w}, cols] {t0.dtype} "
                      f"table on {t0.device} with unit-strided rows")
        _cuda.require(idx.dtype == torch.int64 and idx.device == t0.device
                      and idx.is_contiguous() and tuple(idx.shape) == (w, b),
                      f"{name}: indices {l} must be contiguous int64 [{w}, {b}] "
                      f"on {t0.device}")
        s.tables[l] = table.data_ptr()
        s.idx[l] = idx.data_ptr()
        s.row_stride[l] = table.stride(0)
        s.cols[l] = table.shape[1]
        s.shared[l] = int(residency(w, table.shape[1], table.element_size()) == "shared")
    f = _kernel_freqs(freqs, t0, name, b)
    fn = "sk_conservative_fold_" + ("i32" if t0.dtype == torch.int32 else "f32")
    lib = _cuda.library()
    with torch.cuda.device(t0.device):
        rc = getattr(lib, fn)(ctypes.byref(s), f.data_ptr(), b, index_chunk(w),
                              _cuda.stream_of(t0))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return tables
