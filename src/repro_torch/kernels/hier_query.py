"""K4: all candidate children of heavy prefixes in one launch.

Port of ``repro/kernels/hier_query.py`` (``hier_candidate_query`` and
``hier_candidate_query_batched``).  The mixed-radix cell address is
separable -- ``idx(p, c) = pp[k, p] + cp[k, c]`` per row k -- so the kernel
takes the two partial-index factors and evaluates the full P x C grid
without materialising the key grid.  The TPU kernel gathers through
one-hot MXU contractions on 16-bit table limbs, accumulated over a
sequential tile grid; the Hopper kernel (``sk_hier_query_kernel`` in
``csrc/sketch_kernels.cu``) runs one thread per (p, c) lane, loads the w
cells and keeps the minimum in a register.  It reads the table through a
row stride, so a level view of the concatenated hierarchy table is never
copied.  :func:`hier_candidate_query_ref` is its plain PyTorch version; the
wrapper runs it only for tensors on the CPU.  The signed grid arrives with
a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _cuda


def hier_candidate_query_ref(table: torch.Tensor, pp: torch.Tensor,
                             cp: torch.Tensor) -> torch.Tensor:
    """Plain version: [P, C] in the table's dtype (exact for any dtype)."""
    w = table.shape[0]
    idx = (pp[:, :, None] + cp[:, None, :]).reshape(w, -1)
    vals = torch.gather(table, 1, idx)
    return vals.min(dim=0).values.reshape(pp.shape[1], cp.shape[1])


def hier_candidate_query(table: torch.Tensor, pp: torch.Tensor,
                         cp: torch.Tensor) -> torch.Tensor:
    """Count-Min estimates for every (prefix, candidate) child: int32[P, C].

    table int32[w, h] (rows may be strided, e.g. a level view); pp int64[w,
    P] prefix partials (pre-scaled); cp int64[w, C] child partials.  CUDA
    tensors launch K4; CPU tensors take :func:`hier_candidate_query_ref`.
    """
    name = "hier_query"
    if not table.is_cuda:
        if table.dtype != torch.int32:
            raise ValueError(
                f"hier_candidate_query supports int32 tables only (got "
                f"{table.dtype}); use hier_candidate_query_ref")
        return hier_candidate_query_ref(table, pp, cp)
    _cuda.require_int32_table(table, name)
    _cuda.require(table.device == pp.device == cp.device,
                  f"{name}: table, pp and cp must share a device")
    _cuda.require(table.dim() == 2 and table.stride(1) == 1,
                  f"{name}: table rows must be unit-stride")
    _cuda.require_on(table.device, name, pp=pp, cp=cp)
    w = table.shape[0]
    _cuda.require(pp.dtype == cp.dtype == torch.int64 and pp.dim() == cp.dim() == 2
                  and pp.shape[0] == cp.shape[0] == w,
                  f"{name}: pp {tuple(pp.shape)} and cp {tuple(cp.shape)} must "
                  f"be int64[{w}, *]")
    p, c = pp.shape[1], cp.shape[1]
    out = torch.empty((p, c), dtype=torch.int32, device=table.device)
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = lib.sk_hier_query(table.data_ptr(), table.stride(0), w,
                               pp.data_ptr(), p, cp.data_ptr(), c,
                               out.data_ptr(), _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out


def hier_candidate_query_batched(table: torch.Tensor, pp: torch.Tensor,
                                 cp: torch.Tensor) -> torch.Tensor:
    """Count-Min estimates for Q requests' (prefix, candidate) grids:
    int32[Q, P, C] from [w, Q, P] prefix partials, one launch total (the
    request axis rides the prefix axis)."""
    w, q, p = pp.shape
    flat = hier_candidate_query(table, pp.reshape(w, q * p), cp)
    return flat.reshape(q, p, cp.shape[1])


def hier_candidate_query_batched_ref(table: torch.Tensor, pp: torch.Tensor,
                                     cp: torch.Tensor) -> torch.Tensor:
    """Plain request-axis version: [w, Q, P] partials -> [Q, P, C]."""
    w, q, p = pp.shape
    flat = hier_candidate_query_ref(table, pp.reshape(w, q * p), cp)
    return flat.reshape(q, p, cp.shape[1])
