"""K2, K7 and K7m: point queries on a flat sketch table.

Port of ``repro/kernels/sketch_query.py``.  The TPU kernels gather through
one-hot MXU contractions on 16-bit table limbs and leave the reduction over
rows to the wrapper.  On Hopper the three run one body
(``csrc/point_query.cuh``): a query's lanes hash the w rows of its key in
registers and load the w cells, and its first lane writes

- K2 (``sketch_query``, ``sketch_query_pallas``): the minimum over rows,
  int32[Q];
- K7 (``sketch_query_signed``, ``sketch_query_signed_pallas``): the
  signed rows ``table[k, idx_k] * s_k``, int32[w, Q], bit-comparable to
  ``core.countsketch.query_rows``;
- K7m (``sketch_query_signed_median``): the median over K7's rows,
  float32[Q], equal to ``countsketch.median_rows`` of K7's rows bit for
  bit, in the same launch (the reference takes this median after its
  kernel).

A query takes :func:`point_lanes` consecutive lanes of a warp, each
hashing and loading some of its rows; the first gathers the cells by warp
shuffles.  One lane a query covers all w rows (the flat paths' 65,536
queries); the accuracy path's 500 take one lane a row.

The ``*_ref`` functions are their plain PyTorch versions; the wrappers run
them only for tensors on the CPU.  A CUDA tensor always launches the
kernel, and a failed build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.countsketch import median_rows
from repro_torch.kernels import _cuda
from repro_torch.kernels.hashes import IndexPlan, all_indices, all_sign_bits
from repro_torch.kernels.hier_query import THREADS, UNROLLED_ROWS

LANE_THREADS_PER_SM = 2 * THREADS


def max_lanes(w: int) -> int:
    """The most lanes a query may take: w rounded up to a power of two
    while the kernels unroll w rows (1-8), else 1 (the runtime loop)."""
    if w < 1 or w > UNROLLED_ROWS:
        return 1
    return 1 << (w - 1).bit_length()


def point_lanes(w: int, n: int, sms: int) -> int:
    """Lanes a query takes in K2, K7 and K7m: the most, up to
    ``max_lanes(w)``, that keep the launch within LANE_THREADS_PER_SM
    threads an SM.

    One lane a query hashes its w rows one after another, each row's cell
    load in flight while the next hashes; one lane a row hashes once
    before its load, but reads the key and gathers the cells by shuffles
    in every lane.  Few queries leave the card thinly filled, so their
    rows spread over lanes; once the queries alone hold about two CTAs an
    SM, more lanes only add key reads and shuffles (``tools/query_ab.py
    --point``'s sweep, PERF.md: the flat paths' 65,536 queries take one
    lane, the accuracy path's 500 at w = 5 take eight)."""
    lanes = max_lanes(w)
    while lanes > 1 and n * lanes > sms * LANE_THREADS_PER_SM:
        lanes //= 2
    return lanes


def _launch(name: str, symbol: str, plan: IndexPlan, table: torch.Tensor,
            chunks: torch.Tensor, q: torch.Tensor, r: torch.Tensor, signs,
            shape, dtype) -> torch.Tensor:
    """Check the inputs, launch K2, K7 or K7m into a new ``shape`` tensor of
    ``dtype`` with the lanes :func:`point_lanes` picks, and count the
    launch; raise if it fails (nothing falls back).  No query launches
    nothing."""
    _cuda.require_hash_inputs(name, plan, table, chunks, q, r, signs=signs)
    w, h_pad = table.shape
    _cuda.require(plan.table_size <= h_pad,
                  f"{name}: table width {h_pad} below the plan's {plan.table_size}")
    out = torch.empty(shape, dtype=dtype, device=table.device)
    n = chunks.shape[0]
    if n == 0:
        return out
    lanes = point_lanes(w, n, _cuda.sm_count(table.device.index))
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = getattr(lib, symbol)(
            ctypes.byref(_cuda.plan_struct(plan)), table.data_ptr(), h_pad, w,
            chunks.data_ptr(), n, q.data_ptr(), r.data_ptr(),
            *(s.data_ptr() for s in signs), out.data_ptr(), lanes, _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


def sketch_query_ref(plan: IndexPlan, table: torch.Tensor, chunks: torch.Tensor,
                     q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Plain version: gather + min over rows, int32[Q]."""
    idx = all_indices(plan, chunks, q, r)                     # [w, Q]
    vals = torch.gather(table.to(torch.int32), 1, idx)
    return vals.min(dim=0).values


def sketch_query(plan: IndexPlan, table: torch.Tensor, chunks: torch.Tensor,
                 q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Count-Min estimates for Q queries: int32[Q].

    table int32[w, h_pad]; chunks int64[Q, C]; q int64[w, C]; r int64[w, m].
    CUDA tensors launch K2; CPU tensors take :func:`sketch_query_ref`.
    """
    if not table.is_cuda:
        return sketch_query_ref(plan, table, chunks, q, r)
    return _launch("sketch_query", "sk_sketch_query", plan, table, chunks, q, r, (),
                   (chunks.shape[0],), torch.int32)


def sketch_query_signed_ref(plan: IndexPlan, table: torch.Tensor,
                            chunks: torch.Tensor, q: torch.Tensor,
                            r: torch.Tensor, sq: torch.Tensor,
                            sr: torch.Tensor) -> torch.Tensor:
    """Plain version: gather, times the +-1 sign in the table's dtype:
    [w, Q] (int32 for int32 tables, as the kernel)."""
    idx = all_indices(plan, chunks, q, r)                     # [w, Q]
    bits = all_sign_bits(plan, chunks, sq, sr)
    sign = 1 - 2 * ((bits >> (len(plan.group_cols) - 1)) & 1)
    return torch.gather(table, 1, idx) * sign.to(table.dtype)


def sketch_query_signed(plan: IndexPlan, table: torch.Tensor,
                        chunks: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                        sq: torch.Tensor, sr: torch.Tensor) -> torch.Tensor:
    """Per-row signed estimates for Q queries: int32[w, Q].

    table int32[w, h_pad]; chunks int64[Q, C]; q, sq int64[w, C]; r, sr
    int64[w, m].  CUDA tensors launch K7; CPU tensors take
    :func:`sketch_query_signed_ref`.
    """
    if not table.is_cuda:
        return sketch_query_signed_ref(plan, table, chunks, q, r, sq, sr)
    return _launch("sketch_query_signed", "sk_sketch_query_signed", plan, table, chunks,
                   q, r, (sq, sr), (table.shape[0], chunks.shape[0]), torch.int32)


def sketch_query_signed_median_ref(plan: IndexPlan, table: torch.Tensor,
                                   chunks: torch.Tensor, q: torch.Tensor,
                                   r: torch.Tensor, sq: torch.Tensor,
                                   sr: torch.Tensor) -> torch.Tensor:
    """Plain version of K7m: ``median_rows`` of
    :func:`sketch_query_signed_ref`, float32[Q]."""
    return median_rows(sketch_query_signed_ref(plan, table, chunks, q, r, sq, sr))


def sketch_query_signed_median(plan: IndexPlan, table: torch.Tensor,
                               chunks: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                               sq: torch.Tensor, sr: torch.Tensor) -> torch.Tensor:
    """Median signed estimates for Q queries: float32[Q], ``median_rows``
    of :func:`sketch_query_signed`.

    Inputs as :func:`sketch_query_signed`.  CUDA tensors launch K7m, whose
    result equals ``median_rows`` of K7's rows bit for bit; CPU tensors
    take :func:`sketch_query_signed_median_ref`.
    """
    if not table.is_cuda:
        return sketch_query_signed_median_ref(plan, table, chunks, q, r, sq, sr)
    return _launch("sketch_query_signed_median", "sk_sketch_query_signed_median", plan,
                   table, chunks, q, r, (sq, sr), (chunks.shape[0],), torch.float32)
