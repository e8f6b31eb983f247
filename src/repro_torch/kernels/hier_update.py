"""K3 and K8: fold one stream block into ALL hierarchy levels in a single
launch.

Port of ``repro/kernels/hier_update.py`` (``hier_update_pallas``).  Under
the shared per-group hash family (core/hierarchy.py) the level indices
nest in the mixed radix,

    idx_L = idx_finest // (r_{L+1} * ... * r_{m-1}),

so one composite hash per (row, item) determines every level's cell.  The
levels live concatenated in one padded table ``[w, sum_L h_L_pad]``.  The
TPU kernel walks that table tile by tile with one-hot limb matmuls; the
Hopper kernel (``sk_hier_update_kernel`` in ``csrc/sketch_kernels.cu``)
runs one thread per (row, item), hashes once and adds with one int32
``atomicAdd`` per level.  :func:`hier_update_ref` is its plain PyTorch
version; the wrapper runs it only for tensors on the CPU.  Both update the
table in place (the reference donates it).

K8 is the signed fold of ``hier_update_signed_pallas``: level L adds
``s_L(x) * f``, where s_L is bit L of the packed cumulative sign parities.
Its kernel (``sk_hier_update_signed_kernel`` in ``csrc/signed_kernels.cu``)
hashes the finest index and the sign bits once per (row, item) and issues
one int32 ``atomicAdd`` per level; :func:`hier_update_signed_ref` is its
plain version.

On float32 tables the same kernels run as K3f and K8f (the reference's
``_hier_kernel_f32`` and ``_hier_kernel_signed_f32``): float32 values, the
sign an exact negation, float ``atomicAdd``s.  K8f folds the gradient
compressor's two-level sketch of every large leaf in one launch
(core/countsketch.hier_fold_tables).  Float atomics add in any order, so
a float32 table equals its plain version bit for bit while every cell's
partial sums are integers below 2^24, and within float32 rounding
otherwise: the reference's contract (hier_update.py:35-38).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.hashes import IndexPlan, all_indices, all_sign_bits, make_plan


class HierPlan(NamedTuple):
    """Static layout of the fused multi-level update.

    ``plan`` is the FINEST level's IndexPlan (group-major chunk layout);
    every coarser level's index is plan's composite index divided by its
    ``level_divs`` entry.  Level l's table occupies columns
    ``[level_offsets[l], level_offsets[l] + level_sizes[l])`` of the
    concatenated table, zero-padded up to ``level_pads[l]`` (a tile_h
    multiple, kept so tables and state_dicts match the reference's)."""
    plan: IndexPlan
    level_sizes: Tuple[int, ...]    # h_l (unpadded cells per row)
    level_pads: Tuple[int, ...]     # h_l padded to a tile_h multiple
    level_divs: Tuple[int, ...]     # idx_l = idx_finest // div_l
    tile_h: int

    @property
    def n_levels(self) -> int:
        return len(self.level_sizes)

    @property
    def padded_cols(self) -> int:
        return sum(self.level_pads)

    @property
    def level_offsets(self) -> Tuple[int, ...]:
        out, off = [], 0
        for p in self.level_pads:
            out.append(off)
            off += p
        return tuple(out)


def make_hier_plan(hspec, tile_h: int = 512) -> HierPlan:
    """Build the fused-update plan from a core.hierarchy.HierarchySpec."""
    fine = hspec.levels[-1]
    if fine.table_size >= 1 << 31:
        raise ValueError("finest table size must fit int32 cell indices")
    pads = tuple(-(-s.table_size // tile_h) * tile_h for s in hspec.levels)
    return HierPlan(
        plan=make_plan(fine),
        level_sizes=tuple(s.table_size for s in hspec.levels),
        level_pads=pads,
        level_divs=tuple(int(d) for d in hspec.level_divisors),
        tile_h=int(tile_h),
    )


def hier_update_ref(hplan: HierPlan, table: torch.Tensor, chunks: torch.Tensor,
                    freqs: torch.Tensor, q: torch.Tensor,
                    r: torch.Tensor) -> torch.Tensor:
    """Plain version over the SAME concatenated padded table, in place:
    per-row composite hash once, cascade divisions, per-level
    scatter-adds."""
    idx_fine = all_indices(hplan.plan, chunks, q, r)          # int64[w, B]
    w, cols = table.shape
    rows = torch.arange(w, dtype=torch.int64, device=table.device)[:, None]
    f = freqs.to(table.dtype).expand(w, freqs.shape[0]).reshape(-1)
    flat_table = table.view(-1)
    for off, div in zip(hplan.level_offsets, hplan.level_divs):
        flat = (rows * cols + idx_fine // div + off).reshape(-1)
        flat_table.index_add_(0, flat, f)
    return table


def hier_update(hplan: HierPlan, table: torch.Tensor, chunks: torch.Tensor,
                freqs: torch.Tensor, q: torch.Tensor,
                r: torch.Tensor) -> torch.Tensor:
    """Fold one block into every level's table in ONE launch, in place.

    table [w, hplan.padded_cols]; chunks int64[B, C] in the finest level's
    (group-major) layout; freqs [B]; q int64[w, C]; r int64[w, m] -- the
    shared family.  Zero-frequency rows are no-ops; level pad columns are
    never hit.  CUDA tensors launch K3 (int32 tables) or K3f (float32);
    CPU tensors take :func:`hier_update_ref`.
    """
    w, cols = table.shape
    if cols != hplan.padded_cols:
        raise ValueError(
            f"concatenated table has {cols} columns, plan expects "
            f"{hplan.padded_cols}")
    if not table.is_cuda:
        return hier_update_ref(hplan, table, chunks, freqs, q, r)
    name, symbol, vdtype = _cuda.fold_variant(table, "hier_update", "sk_hier_update")
    _cuda.require_hash_inputs(name, hplan.plan, table, chunks, q, r, _cuda.FOLD_DTYPES)
    freqs = freqs.to(vdtype)
    _cuda.require_on(table.device, name, freqs=freqs)
    b = chunks.shape[0]
    _cuda.require(tuple(freqs.shape) == (b,),
                  f"{name}: freqs {tuple(freqs.shape)} do not match {b} rows")
    plan_c = _cuda.plan_struct(hplan.plan)
    levels_c = _cuda.levels_struct(hplan.level_offsets, hplan.level_divs)
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = getattr(lib, symbol)(
            ctypes.byref(plan_c), ctypes.byref(levels_c), table.data_ptr(),
            cols, w, chunks.data_ptr(), freqs.data_ptr(), b, q.data_ptr(),
            r.data_ptr(), _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return table


def hier_update_signed_ref(hplan: HierPlan, table: torch.Tensor,
                           chunks: torch.Tensor, freqs: torch.Tensor,
                           q: torch.Tensor, r: torch.Tensor, sq: torch.Tensor,
                           sr: torch.Tensor) -> torch.Tensor:
    """Plain version over the same concatenated padded table, in place:
    indices and sign bits hashed once per row, cascade divisions, per-level
    signed scatter-adds.  The sign multiplies the frequency in the table's
    dtype (int32 wraps as the kernel's atomics do)."""
    idx_fine = all_indices(hplan.plan, chunks, q, r)          # int64[w, B]
    bits = all_sign_bits(hplan.plan, chunks, sq, sr)          # int64[w, B]
    w, cols = table.shape
    rows = torch.arange(w, dtype=torch.int64, device=table.device)[:, None]
    f = freqs.to(table.dtype)[None, :]
    flat_table = table.view(-1)
    for lvl, (off, div) in enumerate(zip(hplan.level_offsets, hplan.level_divs)):
        sign = (1 - 2 * ((bits >> lvl) & 1)).to(table.dtype)
        flat = (rows * cols + idx_fine // div + off).reshape(-1)
        flat_table.index_add_(0, flat, (sign * f).reshape(-1))
    return table


def hier_update_signed(hplan: HierPlan, table: torch.Tensor,
                       chunks: torch.Tensor, freqs: torch.Tensor,
                       q: torch.Tensor, r: torch.Tensor, sq: torch.Tensor,
                       sr: torch.Tensor) -> torch.Tensor:
    """Signed fold of one block into every level's table in ONE launch, in
    place.

    As :func:`hier_update`, plus the shared sign params sq int64[w, C] and
    sr int64[w, m]; freqs may be negative.  CUDA tensors launch K8 (int32
    tables) or K8f (float32); CPU tensors take
    :func:`hier_update_signed_ref`.
    """
    w, cols = table.shape
    if cols != hplan.padded_cols:
        raise ValueError(
            f"concatenated table has {cols} columns, plan expects "
            f"{hplan.padded_cols}")
    if not table.is_cuda:
        return hier_update_signed_ref(hplan, table, chunks, freqs, q, r, sq, sr)
    name, symbol, vdtype = _cuda.fold_variant(table, "hier_update_signed",
                                              "sk_hier_update_signed")
    _cuda.require_hash_inputs(name, hplan.plan, table, chunks, q, r, _cuda.FOLD_DTYPES)
    _cuda.require_hash_inputs(name, hplan.plan, table, chunks, sq, sr, _cuda.FOLD_DTYPES)
    freqs = freqs.to(vdtype)
    _cuda.require_on(table.device, name, freqs=freqs)
    b = chunks.shape[0]
    _cuda.require(tuple(freqs.shape) == (b,),
                  f"{name}: freqs {tuple(freqs.shape)} do not match {b} rows")
    plan_c = _cuda.plan_struct(hplan.plan)
    levels_c = _cuda.levels_struct(hplan.level_offsets, hplan.level_divs)
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = getattr(lib, symbol)(
            ctypes.byref(plan_c), ctypes.byref(levels_c), table.data_ptr(),
            cols, w, chunks.data_ptr(), freqs.data_ptr(), b, q.data_ptr(),
            r.data_ptr(), sq.data_ptr(), sr.data_ptr(), _cuda.stream_of(table))
    _cuda.check(rc, name)
    _cuda.LAUNCHES[name] += 1
    return table
