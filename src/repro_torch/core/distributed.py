"""Distributed sketch runtime, PyTorch port of ``repro/core/distributed.py``.

The sketch table is *linear* in the stream, so the cluster-scale pattern is:

  1. shard the incoming stream over the data-parallel mesh axes,
  2. every shard folds its slice into a shard-local table,
  3. merge by ``psum`` over the data axes at sync points (exact by
     linearity).

Queries run on the merged table; for row-sharded tables (w split over the
"model" axis) a min over each shard's rows and then over the shards
completes the Count-Min min (:func:`row_sharded_query`).

The port keeps the reference's single controller: one caller owns the
whole :class:`~repro_torch.launch.mesh.Mesh`, where the reference runs a
``shard_map``.  Shard s of a block is its s-th contiguous slice and lives
on ``mesh.axis_devices(data_axes)[s]``; :func:`psum` is a reduction over
the shards' tensors, in shard order, onto the destination device (the
mesh's first), one code path whether the shards share a device or not.

Each shard's fold is one launch of a hand-written kernel on that shard's
device and slice when the tensors lie on a card: K1 for the flat linear
fold, K6 for the signed fold, K3 (K3f on float32 tables) for the
hierarchy fold into every level at once.  The kernel wrappers run their
plain scatter only for tensors on the CPU.  Integer sums are exact in any
order, so int32 results equal the reference's bit for bit at any shard
count; float32 sums are exact while every partial sum is an integer below
2^24, and within float32 rounding otherwise.

Layout difference from the reference, invisible in any output: the lazy
hierarchy locals are one buffer a shard holding every level side by side
(``kernels/hier_update.HierPlan`` at ``tile_h=1``), where the reference
keeps one ``[n_shards, w, h_level]`` stack a level.  One K3 launch then
folds a shard's slice into all its levels in place.

Every psum path assumes the *linear* update (or the signed one, whose
cells are also plain sums).  Conservative tables are not linear in the
stream and are refused by :func:`require_linear` on every entry point.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def require_linear(mode: str, entry: str) -> None:
    """Refuse conservative tables on any sharded/merge entry point, with the
    reference's message: a psum (or cell-wise sum) of conservatively built
    tables is not the table of the union stream.  Linear and signed tables
    are linear in the stream and pass."""
    if mode not in ("linear", "signed"):
        raise ValueError(
            f"{entry} is only defined for linear tables (got mode="
            f"{mode!r}): conservative tables are not linear in the stream, "
            "so per-shard folds cannot be psum-merged -- conservative mode "
            "is single-shard by construction")


def pad_block_pow2(items: np.ndarray, freqs: np.ndarray, n_shards: int):
    """Pad a stream block so each of ``n_shards`` contiguous slices has the
    same power-of-two length.

    Zero-frequency pad rows are no-ops under the linear update and are
    skipped by the candidate pools, so padding never changes any table.
    Kept from the reference (where it bounds the number of compiled
    variants) so every sharded entry point and the single-shard endpoint
    fold exactly the slices the reference folds.

    Returns (items, freqs, rows_per_shard).
    """
    n = items.shape[0]
    per = -(-n // n_shards)
    per = 1 << max(per - 1, 0).bit_length()
    m = per * n_shards
    if m != n:
        items = np.pad(items, ((0, m - n), (0, 0)))
        freqs = np.pad(freqs, (0, m - n))
    return items, freqs, per


# --------------------------------------------------------------------------
# placement and the collective
# --------------------------------------------------------------------------

def place(x, device: torch.device):
    """``x`` (a tensor or a NamedTuple of them, e.g. hash params) on
    ``device``; tensors already there are returned as they are."""
    if isinstance(x, torch.Tensor):
        return x if x.device == device else x.to(device)
    return type(x)(*(place(v, device) for v in x))


def psum(tensors: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """Sum of the shards' tensors, in shard order, as a new tensor on
    ``device`` (the inputs are never aliased)."""
    device = torch.device(device)
    out = tensors[0].to(device, copy=True)
    for t in tensors[1:]:
        out.add_(t.to(device))
    return out


def _slices(items, freqs, n_shards: int):
    """The n contiguous equal slices of a block (B % n_shards == 0)."""
    b = items.shape[0]
    if b % n_shards:
        raise ValueError(f"a block of {b} rows does not split over {n_shards} "
                         "shards (pad it with pad_block_pow2)")
    per = b // n_shards
    return [(items[s * per:(s + 1) * per], freqs[s * per:(s + 1) * per])
            for s in range(n_shards)]


def _shard_inputs(spec, items, freqs, device, dtype):
    """A shard's slice as the fold kernels take it: the key chunks and the
    frequencies in the table's dtype, on the shard's device."""
    from repro_torch.core import sketch as sk
    from repro_torch.device import as_index_tensor

    chunks = spec.schema.module_chunks(as_index_tensor(items, device))
    return chunks, sk.as_freqs(freqs, device).to(dtype)


# --------------------------------------------------------------------------
# flat sketches
# --------------------------------------------------------------------------

def _flat_fold(spec, params, table: torch.Tensor, items, freqs) -> torch.Tensor:
    """One shard's linear fold, in place: K1 (K1f) on the card."""
    from repro_torch.kernels.hashes import make_plan
    from repro_torch.kernels.sketch_update import sketch_update

    p = place(params, table.device)
    chunks, f = _shard_inputs(spec, items, freqs, table.device, table.dtype)
    return sketch_update(make_plan(spec), table, chunks, f, p.q, p.r)


def sharded_build(spec, params, mesh, data_axes: Tuple[str, ...], items, freqs,
                  table_dtype=torch.int32) -> torch.Tensor:
    """Build the *merged* table from a stream sharded over ``data_axes``.

    items: uint32[B, n] (numpy or a tensor) with B divisible by the shard
    count.  Each shard folds its slice into a zero table on its device (one
    K1 launch on the card); returns the merged ``[w, h]`` table on the
    mesh's first device."""
    devices = mesh.axis_devices(data_axes)
    parts = []
    for dev, (it, fr) in zip(devices, _slices(items, freqs, len(devices))):
        table = torch.zeros((spec.width, spec.table_size), dtype=table_dtype, device=dev)
        parts.append(_flat_fold(spec, params, table, it, fr))
    return psum(parts, mesh.first_device)


def sharded_signed_build(spec, params, mesh, data_axes: Tuple[str, ...], items,
                         freqs, table_dtype=torch.int32) -> torch.Tensor:
    """Signed (Count-Sketch) counterpart of :func:`sharded_build`;
    ``params`` is a ``core.countsketch.CountSketchParams`` and ``freqs``
    turnstile weights of either sign.

    Each shard hashes its slice once (cells and sign bits) and folds the
    signed weights into a zero table on its device (one K6 launch on the
    card, K6f on float32), then the shards are psum-merged.  The sign
    multiplies the weight in the table's dtype, where the reference rounds
    the product through float32: the two agree while |freq| < 2^24."""
    from repro_torch.kernels.hashes import make_plan
    from repro_torch.kernels.sketch_update import sketch_update_signed

    plan = make_plan(spec)
    devices = mesh.axis_devices(data_axes)
    parts = []
    for dev, (it, fr) in zip(devices, _slices(items, freqs, len(devices))):
        p = place(params, dev)
        table = torch.zeros((spec.width, spec.table_size), dtype=table_dtype, device=dev)
        chunks, f = _shard_inputs(spec, it, fr, dev, table_dtype)
        parts.append(sketch_update_signed(plan, table, chunks, f, p.base.q, p.base.r,
                                          p.sign_q, p.sign_r))
    return psum(parts, mesh.first_device)


def sharded_update(spec, mesh, data_axes: Tuple[str, ...], state, items, freqs):
    """One synchronous distributed update step: local folds + psum merge,
    added to a copy of ``state``'s table."""
    from repro_torch.core import sketch as sk

    delta = sharded_build(spec, state.params, mesh, data_axes, items, freqs,
                          table_dtype=state.table.dtype)
    return sk.SketchState(params=state.params,
                          table=state.table + delta.to(state.table.device))


def init_local_tables(mesh, data_axes: Tuple[str, ...], n_shards: int,
                      shape: Sequence[int], dtype) -> List[torch.Tensor]:
    """Zeroed shard-local tables of ``shape``, one on each shard's device.

    Shared by the sharded service's constructor and its N->M ``remesh``, so
    a re-meshed service's fresh locals land on the NEW devices."""
    devices = mesh.axis_devices(data_axes)
    if len(devices) != n_shards:
        raise ValueError(f"data axes {tuple(data_axes)} hold {len(devices)} shards, "
                         f"not {n_shards}")
    return [torch.zeros(tuple(shape), dtype=dtype, device=d) for d in devices]


def lazy_local_update(spec, mesh, data_axes: Tuple[str, ...],
                      local_tables: List[torch.Tensor], params, items,
                      freqs) -> List[torch.Tensor]:
    """Asynchronous variant: each shard folds its slice into its own local
    table (``[w, h]`` on its device, in place); no collective.  Call
    :func:`merge_local_tables` at sync points."""
    for table, (it, fr) in zip(local_tables, _slices(items, freqs, len(local_tables))):
        _flat_fold(spec, params, table, it, fr)
    return local_tables


def merge_local_tables(mesh, data_axes: Tuple[str, ...],
                       local_tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """psum-merge the lazily accumulated shard-local tables onto the mesh's
    first device."""
    return psum(local_tables, mesh.first_device)


# --------------------------------------------------------------------------
# hierarchies
# --------------------------------------------------------------------------

def local_plan(hspec):
    """The layout of a shard's hierarchy buffer: every level side by side,
    unpadded (``[w, sum_L h_L]``)."""
    from repro_torch.kernels.hier_update import make_hier_plan

    return make_hier_plan(hspec, tile_h=1)


def level_views(hplan, buf: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The level tables of a hierarchy buffer, as views."""
    return tuple(buf[:, off:off + h]
                 for off, h in zip(hplan.level_offsets, hplan.level_sizes))


def _hier_fold(hspec, hplan, fine_params, buf: torch.Tensor, items, freqs) -> None:
    """One shard's fold of its slice into every level of ``buf``, in place:
    one K3 launch (K3f on float32) on the card."""
    from repro_torch.kernels.hier_update import hier_update

    p = place(fine_params, buf.device)
    # group-major columns: the finest level's chunk layout
    chunks, f = _shard_inputs(hspec.levels[-1], hspec.level_items(hspec.n_levels - 1, items),
                              freqs, buf.device, buf.dtype)
    hier_update(hplan, buf, chunks, f, p.q, p.r)


def lazy_hierarchy_update(hspec, mesh, data_axes: Tuple[str, ...],
                          local_tables: Sequence[torch.Tensor], params, items,
                          freqs, *, mode: str = "linear",
                          hplan=None) -> Sequence[torch.Tensor]:
    """Lazy local fold of ALL hierarchy levels: no collective on ingest, no
    per-level re-hash, no per-level launch.

    ``local_tables`` holds one buffer a shard (:func:`local_plan`'s layout,
    on the shard's device); shard s folds the s-th slice of the block into
    its buffer in place, hashing each item once and deriving every level's
    cell by the cascade's divisions.  ``params``: the finest level's
    (shared-family) params, from which the cascade derives every level's
    (the reference takes one entry a level and reads only the last).  The
    merge is deferred to :func:`merge_local_hierarchy`.  Linear tables
    only.
    """
    require_linear(mode, "lazy_hierarchy_update")
    hplan = local_plan(hspec) if hplan is None else hplan
    for buf, (it, fr) in zip(local_tables, _slices(items, freqs, len(local_tables))):
        _hier_fold(hspec, hplan, params, buf, it, fr)
    return local_tables


def merge_local_hierarchy(mesh, data_axes: Tuple[str, ...],
                          local_tables: Sequence[torch.Tensor],
                          hplan) -> Tuple[torch.Tensor, ...]:
    """psum-merge every shard's hierarchy buffer onto the mesh's first
    device; returns the merged level tables (views of one new buffer).
    Exact by linearity on integer tables, for any shard count."""
    return level_views(hplan, psum(local_tables, mesh.first_device))


def sharded_hierarchy_fold(hspec, fine_params, mesh, data_axes: Tuple[str, ...],
                           items, freqs, *,
                           table_dtypes: Sequence = ()) -> Tuple[torch.Tensor, ...]:
    """Synchronous sharded build of every level's MERGED delta: each shard
    folds its slice into a zero buffer of all levels on its device (one K3
    launch, K3f on float32), then the buffers are psum-merged.

    ``table_dtypes`` gives each level's dtype (default int32); the levels
    share one buffer a shard, so they must agree.  Returns one
    ``[w, h_level]`` table per level on the mesh's first device."""
    dtypes = set(table_dtypes) or {torch.int32}
    if len(dtypes) != 1:
        raise ValueError(f"the levels' tables must share one dtype, got {sorted(map(str, dtypes))}")
    (dtype,) = dtypes
    hplan = local_plan(hspec)
    devices = mesh.axis_devices(data_axes)
    bufs = []
    for dev, (it, fr) in zip(devices, _slices(items, freqs, len(devices))):
        buf = torch.zeros((hspec.base.width, hplan.padded_cols), dtype=dtype, device=dev)
        _hier_fold(hspec, hplan, fine_params, buf, it, fr)
        bufs.append(buf)
    return merge_local_hierarchy(mesh, data_axes, bufs, hplan)


# --------------------------------------------------------------------------
# row-sharded queries
# --------------------------------------------------------------------------

def row_sharded_query(spec, mesh, model_axis: str, params, table: torch.Tensor,
                      items) -> torch.Tensor:
    """Count-Min query with the w rows sharded over the model axis.

    Shard g holds rows ``[g*w/n, (g+1)*w/n)`` on its device and takes the
    min over them; a min over the shards, onto the mesh's first device,
    completes the global min.  w must be divisible by the axis size.  The
    reference gathers in jnp here (no kernel); so does the port."""
    from repro_torch.core import sketch as sk

    devices = mesh.axis_devices((model_axis,))
    n, w = len(devices), table.shape[0]
    if w % n:
        raise ValueError(f"w = {w} rows do not split over {n} shards of {model_axis!r}")
    wl = w // n
    sub_spec = sk.SketchSpec(spec.schema, spec.partition, spec.ranges, wl)
    out = None
    for g, dev in enumerate(devices):
        rows = slice(g * wl, (g + 1) * wl)
        p = sk.SketchParams(q=params.q[rows].to(dev), r=params.r[rows].to(dev))
        idx = sk.compute_indices(sub_spec, p, items)
        local = torch.gather(table[rows].to(dev), 1, idx).min(dim=0).values
        local = local.to(mesh.first_device)
        out = local if out is None else torch.minimum(out, local)
    return out
