"""K4 and K9: all candidate children of heavy prefixes in one launch.

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
wrapper runs it only for tensors on the CPU.

K9 is the signed grid of ``hier_candidate_query_signed``: the sign of child
(p, c) at row k is ``sp[k, p] * sc[k, c]`` (cumulative parities XOR, so +-1
signs multiply), computed outside the kernel by
``core.countsketch.candidate_signed_partials`` like the bucket partials.
The kernel (``sk_hier_query_signed_kernel`` in ``csrc/signed_kernels.cu``)
runs one thread per (row, p, c) lane, reads the level view in place and
writes the signed int32 value; the caller takes the median over rows.
:func:`hier_candidate_query_signed_ref` is its plain version, which signs
in float32 as the reference's oracle does: the two agree exactly except on
a cell holding -2^31 under sign -1, where int32 wraps (as the reference's
kernel does too).
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


def hier_candidate_query_signed_ref(table: torch.Tensor, pp: torch.Tensor,
                                    cp: torch.Tensor, sp: torch.Tensor,
                                    sc: torch.Tensor) -> torch.Tensor:
    """Plain version: float32[w, P, C] per-row estimates (gather in the
    table's dtype, sign applied in float32; any dtype)."""
    w = table.shape[0]
    p, c = pp.shape[1], cp.shape[1]
    idx = (pp[:, :, None] + cp[:, None, :]).reshape(w, -1)
    vals = torch.gather(table, 1, idx).to(torch.float32).reshape(w, p, c)
    return vals * sp.to(torch.float32)[:, :, None] * sc.to(torch.float32)[:, None, :]


def hier_candidate_query_signed(table: torch.Tensor, pp: torch.Tensor,
                                cp: torch.Tensor, sp: torch.Tensor,
                                sc: torch.Tensor) -> torch.Tensor:
    """Per-row signed estimates for every (prefix, candidate) child:
    int32[w, P, C] on the card (the caller takes the median over rows).

    table int32[w, h] (rows may be strided, e.g. a level view); pp int64[w,
    P] and cp int64[w, C] bucket partials; sp float32[w, P] and sc
    float32[w, C] +-1 sign partials.  CUDA tensors launch K9; CPU tensors
    take :func:`hier_candidate_query_signed_ref`.
    """
    if not table.is_cuda:
        return hier_candidate_query_signed_ref(table, pp, cp, sp, sc)
    name = "hier_query_signed"
    _cuda.require_int32_table(table, name)
    _cuda.require(table.dim() == 2 and table.stride(1) == 1,
                  f"{name}: table rows must be unit-stride")
    _cuda.require_on(table.device, name, pp=pp, cp=cp, sp=sp, sc=sc)
    w = table.shape[0]
    p, c = pp.shape[1], cp.shape[1]
    _cuda.require(pp.dtype == cp.dtype == torch.int64
                  and sp.dtype == sc.dtype == torch.float32
                  and pp.dim() == cp.dim() == 2 and w <= 65535
                  and tuple(pp.shape) == tuple(sp.shape) == (w, p)
                  and tuple(cp.shape) == tuple(sc.shape) == (w, c),
                  f"{name}: pp {tuple(pp.shape)} and cp {tuple(cp.shape)} must be "
                  f"int64[{w}, *], sp {tuple(sp.shape)} and sc {tuple(sc.shape)} "
                  "float32 of the same shapes")
    out = torch.empty((w, p, c), dtype=torch.int32, device=table.device)
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = lib.sk_hier_query_signed(table.data_ptr(), table.stride(0), w,
                                      pp.data_ptr(), sp.data_ptr(), p,
                                      cp.data_ptr(), sc.data_ptr(), c,
                                      out.data_ptr(), _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return out
