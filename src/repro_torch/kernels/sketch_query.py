"""K2: Count-Min point queries on a flat sketch table.

Port of ``repro/kernels/sketch_query.py`` (``sketch_query_pallas``).  The
TPU kernel gathers through one-hot MXU contractions on 16-bit table limbs
and leaves the row minimum to the wrapper; on Hopper the kernel
(``sk_query_kernel`` in ``csrc/sketch_kernels.cu``) runs one thread per
query, hashes each row, loads the cell and keeps the minimum in a register.
:func:`sketch_query_ref` is its plain PyTorch version; the wrapper runs it
only for tensors on the CPU.  The signed variant arrives with a later slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.hashes import IndexPlan, all_indices


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
