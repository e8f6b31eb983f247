"""K3 and K8: fold one stream block into ALL hierarchy levels in a single
launch.

Port of ``repro/kernels/hier_update.py`` (``hier_update_pallas``).  Under
the shared per-group hash family (core/hierarchy.py) the level indices
nest in the mixed radix,

    idx_L = idx_finest // (r_{L+1} * ... * r_{m-1}),

so one composite hash per (row, item) determines every level's cell.  The
levels live concatenated in one padded table ``[w, sum_L h_L_pad]``.  The
TPU kernel walks that table tile by tile with one-hot limb matmuls.

K8 is the signed fold of ``hier_update_signed_pallas``: level L adds
``s_L(x) * f``, where s_L is bit L of the packed cumulative sign parities.

Both run one Hopper body (``csrc/hier_fold.cuh``, entry points
``sk_hier_update_kernel`` and ``sk_hier_update_signed_kernel``): one
thread per item over all w rows hashes the finest index (and the sign
bits) once per (row, item), folds the coarse levels that
:func:`fold_geometry` puts in shared memory into a private copy per CTA
(lanes that hit one cell combined first), adds the other levels with
global atomics, and flushes each CTA's copy at the end.
:func:`hier_update_ref` and :func:`hier_update_signed_ref` are their plain
versions; the wrappers run them only for tensors on the CPU.  All update
the table in place (the reference donates it).

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
from typing import NamedTuple, Optional, Tuple

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
    never hit.  CUDA tensors launch K3 (int32 tables) or K3f (float32)
    with the launch :func:`fold_geometry` picks; CPU tensors take
    :func:`hier_update_ref`.
    """
    w, cols = table.shape
    if cols != hplan.padded_cols:
        raise ValueError(
            f"concatenated table has {cols} columns, plan expects "
            f"{hplan.padded_cols}")
    if not table.is_cuda:
        return hier_update_ref(hplan, table, chunks, freqs, q, r)
    return _launch(hplan, table, chunks, freqs, q, r)


# The launch of both folds (K3, K3f, K8, K8f).  One CTA's dynamic shared
# memory and one SM's on an H100 (227 KB and 228 KB; the SM keeps 1 KB a CTA).
SHARED_BYTES = 232_448
SM_SHARED_BYTES = 233_472
CTA_RESERVED_BYTES = 1_024
THREADS = 256       # kFoldThreads in csrc/hier_fold.cuh: the items of a tile
CTAS_PER_SM = 4     # kHierCtasPerSm there, the kernel's __launch_bounds__
# A CTA walks spans of SPAN_TILES consecutive tiles (16,384 items: over
# three rows of a 4,608-wide gradient matrix), so the items that share a
# coarse cell meet in one CTA; spans dealt round the CTAs spread a sparse
# leaf's nonzero rows over all of them.
SPAN_TILES = 64
# A coarse level repays its shared copy when a CTA folds at least one item
# per REPAY of the level's cells a row.  Zeroing and scanning a cell costs
# about 7 instructions a row, hashing an item and adding it about 200 signed
# (two Carter-Wegman passes, the level divisions), about 100 unsigned, so
# the copy then costs at most about as much again as the CTA's signed
# hashing (twice its unsigned hashing), and it turns the adds of the items
# that share a cell into one global atomic a CTA.  One constant serves both
# folds: on the main path's blocks (256 items a CTA for level 0's 4,096
# cells, one item per 16 cells) the unsigned fold's shared route took 0.59x
# and 0.16x the all-global route's time on an H100 80GB HBM3 at 700 W
# (chip_smoke.py's K3 row, block 0 and the heaviest block; PERF.md), so the
# copy repays there at half the signed fold's hashing as well.
REPAY = 32


class FoldGeometry(NamedTuple):
    """The launch of a hierarchy fold: which levels each CTA folds in its own
    shared copy, and how the items are dealt to the CTAs -- spans of
    ``span_tiles`` tiles of THREADS items, span s to CTA s mod ``ctas``."""
    shared: Tuple[bool, ...]    # per level
    ctas: int
    span_tiles: int
    shared_bytes: int           # dynamic shared memory a CTA

    @property
    def shared_mask(self) -> int:
        return sum(1 << l for l, on in enumerate(self.shared) if on)


def _deal(n: int, smem: int, sms: int) -> Tuple[int, int]:
    """(CTAs, span tiles) for n items at ``smem`` shared bytes a CTA: as
    many CTAs as fit the SMs at once, spans of at most SPAN_TILES."""
    tiles = -(-n // THREADS)
    most = sms * min(CTAS_PER_SM, SM_SHARED_BYTES // (smem + CTA_RESERVED_BYTES))
    span = max(1, min(SPAN_TILES, tiles // most))
    return min(most, -(-tiles // span)), span


def fold_geometry(hplan: HierPlan, w: int, n: int, itemsize: int, sms: int,
                  shared_bytes: Optional[int] = None) -> FoldGeometry:
    """The residency rule of K3/K3f and K8/K8f for a block of ``n`` items into a
    ``[w, hplan.padded_cols]`` table of ``itemsize``-byte cells on a card of
    ``sms`` SMs.  Coarse levels, coarsest first, go to shared memory while
    their ``w x padded cells`` copies fit the budget (SHARED_BYTES unless
    ``shared_bytes`` is given; 0 keeps every level global) and each repays
    its copy (REPAY) at the geometry it leads to.  The finest level stays
    global: its cell is the whole item's hash, so a CTA's items meet there
    only by collision and a copy would combine almost nothing.  Both routes
    run the same kernel."""
    limit = SHARED_BYTES if shared_bytes is None else shared_bytes
    shared = [False] * hplan.n_levels
    smem = 0
    ctas, span = _deal(n, smem, sms)
    for lvl in range(hplan.n_levels - 1):
        pad = hplan.level_pads[lvl]
        cost = w * pad * itemsize
        if smem + cost > limit:
            continue
        c, s = _deal(n, smem + cost, sms)
        if n * REPAY < c * pad:
            continue
        shared[lvl], smem, ctas, span = True, smem + cost, c, s
    return FoldGeometry(tuple(shared), ctas, span, smem)


def _launch(hplan: HierPlan, table: torch.Tensor, chunks: torch.Tensor,
            freqs: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
            signs: Tuple[torch.Tensor, ...] = ()) -> torch.Tensor:
    """Launch K3/K3f, or K8/K8f when ``signs`` holds (sq, sr), on a CUDA
    table with the launch :func:`fold_geometry` picks; raise if it fails."""
    kind = "hier_update_signed" if signs else "hier_update"
    name, symbol, vdtype = _cuda.fold_variant(table, kind, "sk_" + kind)
    _cuda.require_hash_inputs(name, hplan.plan, table, chunks, q, r, _cuda.FOLD_DTYPES,
                              signs)
    freqs = freqs.to(vdtype)
    _cuda.require_on(table.device, name, freqs=freqs)
    b = chunks.shape[0]
    _cuda.require(tuple(freqs.shape) == (b,),
                  f"{name}: freqs {tuple(freqs.shape)} do not match {b} rows")
    w, cols = table.shape
    geometry = fold_geometry(hplan, w, b, table.element_size(),
                             _cuda.sm_count(table.device.index))
    plan_c = _cuda.plan_struct(hplan.plan)
    levels_c = _cuda.levels_struct(hplan.level_offsets, hplan.level_divs)
    lib = _cuda.library()
    with torch.cuda.device(table.device):
        rc = getattr(lib, symbol)(
            ctypes.byref(plan_c), ctypes.byref(levels_c), table.data_ptr(),
            cols, w, chunks.data_ptr(), freqs.data_ptr(), b, q.data_ptr(),
            r.data_ptr(), *(t.data_ptr() for t in signs), geometry.shared_mask,
            geometry.ctas, geometry.span_tiles, geometry.shared_bytes,
            _cuda.stream_of(table))
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
    tables) or K8f (float32) with the launch :func:`fold_geometry` picks;
    CPU tensors take :func:`hier_update_signed_ref`.
    """
    w, cols = table.shape
    if cols != hplan.padded_cols:
        raise ValueError(
            f"concatenated table has {cols} columns, plan expects "
            f"{hplan.padded_cols}")
    if not table.is_cuda:
        return hier_update_signed_ref(hplan, table, chunks, freqs, q, r, sq, sr)
    return _launch(hplan, table, chunks, freqs, q, r, (sq, sr))
