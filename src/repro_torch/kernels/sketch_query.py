"""K2 and K7: point queries on a flat sketch table.

Port of ``repro/kernels/sketch_query.py`` (``sketch_query_pallas``).  The
TPU kernel gathers through one-hot MXU contractions on 16-bit table limbs
and leaves the row minimum to the wrapper; on Hopper the kernel
(``sk_query_kernel`` in ``csrc/sketch_kernels.cu``) runs one thread per
query, hashes each row, loads the cell and keeps the minimum in a register.
:func:`sketch_query_ref` is its plain PyTorch version; the wrapper runs it
only for tensors on the CPU.

K7 is the signed read of ``sketch_query_signed_pallas``: the per-row
values ``table[k, idx_k] * s_k`` as int32[w, Q], from which the caller
takes the median (rows keep the estimator bit-comparable to
``core.countsketch.query_rows``).  Its kernel
(``sk_query_signed_kernel`` in ``csrc/signed_kernels.cu``) runs one thread
per (row, query); :func:`sketch_query_signed_ref` is its plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.hashes import IndexPlan, all_indices, all_sign_bits


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
    name = "sketch_query"
    _cuda.require_hash_inputs(name, plan, table, chunks, q, r)
    w, h_pad = table.shape
    _cuda.require(plan.table_size <= h_pad,
                  f"{name}: table width {h_pad} below the plan's {plan.table_size}")
    n = chunks.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=table.device)
    plan_c = _cuda.plan_struct(plan)
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = lib.sk_sketch_query(
            ctypes.byref(plan_c), table.data_ptr(), h_pad, w, chunks.data_ptr(),
            n, q.data_ptr(), r.data_ptr(), out.data_ptr(), _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


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
    """Per-row signed estimates for Q queries: int32[w, Q] (the caller takes
    the median).

    table int32[w, h_pad]; chunks int64[Q, C]; q, sq int64[w, C]; r, sr
    int64[w, m].  CUDA tensors launch K7; CPU tensors take
    :func:`sketch_query_signed_ref`.
    """
    if not table.is_cuda:
        return sketch_query_signed_ref(plan, table, chunks, q, r, sq, sr)
    name = "sketch_query_signed"
    _cuda.require_hash_inputs(name, plan, table, chunks, q, r, signs=(sq, sr))
    w, h_pad = table.shape
    _cuda.require(plan.table_size <= h_pad,
                  f"{name}: table width {h_pad} below the plan's {plan.table_size}")
    n = chunks.shape[0]
    out = torch.empty((w, n), dtype=torch.int32, device=table.device)
    plan_c = _cuda.plan_struct(plan)
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = lib.sk_sketch_query_signed(
            ctypes.byref(plan_c), table.data_ptr(), h_pad, w, chunks.data_ptr(),
            n, q.data_ptr(), r.data_ptr(), sq.data_ptr(), sr.data_ptr(),
            out.data_ptr(), _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out
