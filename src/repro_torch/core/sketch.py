"""Unified composite-hash sketch family (paper SIII), PyTorch port.

Port of ``repro/core/sketch.py``.  Every sketch studied in the paper is one
point of a single family::

    SketchSpec = (partition G = {g_1..g_m} of modules, ranges r_1..r_m, width w)
    row index  = sum_j  H_{k,j}(pack(key[g_j])) * stride_j     (mixed radix)

Update adds +f to one cell per row; query takes the min over rows.  The
table is linear in the stream, hence sketches merge by cell-wise addition.

This module is the plain PyTorch path (``index_add_`` scatter, ``gather``
reads) on int64 indices.  Hash params are int64 tensors; tables keep their
own dtype.  Where the reference donates the table to a jitted update, the
port updates in place: the ``*_jit`` names and :func:`add_at_indices_` fold
into the given table, the others return a new one.  Conservative update,
the marginal query and ``cell_std`` arrive with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hashing import (
    KeySchema,
    cw_hash,
    cw_hash_np,
    draw_hash_params,
)
from repro_torch.device import DeviceLike, as_index_tensor, resolve_device


# --------------------------------------------------------------------------
# Spec
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SketchSpec:
    """Static description of a composite-hash sketch."""
    schema: KeySchema
    partition: Tuple[Tuple[int, ...], ...]  # ordered groups of module indices
    ranges: Tuple[int, ...]                 # hash range per group
    width: int                              # w rows

    def __post_init__(self):
        n = self.schema.modularity
        seen = sorted(i for g in self.partition for i in g)
        if seen != list(range(n)):
            raise ValueError(f"partition {self.partition} does not cover 0..{n-1}")
        if len(self.ranges) != len(self.partition):
            raise ValueError("one range per group required")
        for r in self.ranges:
            if r < 1:
                raise ValueError(f"range {r} < 1")
        if self.width < 1:
            raise ValueError("width >= 1 required")

    @property
    def n_groups(self) -> int:
        return len(self.partition)

    @property
    def table_size(self) -> int:
        """Cells per row: h = prod(ranges)."""
        return int(np.prod([int(r) for r in self.ranges], dtype=np.int64))

    @property
    def strides(self) -> Tuple[int, ...]:
        s, out = 1, []
        for r in reversed(self.ranges):
            out.append(s)
            s *= int(r)
        return tuple(reversed(out))

    def group_chunk_columns(self, j: int) -> Tuple[int, ...]:
        """Columns of the full chunk matrix belonging to group j (ordered)."""
        cols = []
        for mod in self.partition[j]:
            a, b = self.schema.chunk_slice(mod)
            cols.extend(range(a, b))
        return tuple(cols)

    def describe(self) -> str:
        gs = ",".join("{" + "+".join(str(m) for m in g) + "}" for g in self.partition)
        rs = "x".join(str(r) for r in self.ranges)
        return f"[{gs}] ranges={rs} (h={self.table_size}) w={self.width}"


def count_min_spec(schema: KeySchema, h: int, w: int) -> SketchSpec:
    """Paper baseline (1): concatenate all modules, one hash of range h."""
    return SketchSpec(schema, (tuple(range(schema.modularity)),), (int(h),), w)


def _floor_root(x: int, n: int) -> int:
    """max r >= 1 with r**n <= x, exact (float root + integer adjustment)."""
    r = max(1, int(round(x ** (1.0 / n))))
    while r > 1 and r ** n > x:
        r -= 1
    while (r + 1) ** n <= x:
        r += 1
    return r


def equal_ranges(h: int, n: int) -> Tuple[int, ...]:
    """n integer ranges ~ h^(1/n) with ``prod(ranges) <= h`` guaranteed.

    Greedy floor-root split: range j is the floor (n-j)-th root of the
    remaining budget, so the product never exceeds the allocated table
    size.  Ranges degrade to 1 when h < 2**n.
    """
    if n < 1:
        raise ValueError("need n >= 1 ranges")
    rem = max(1, int(h))
    ranges = []
    for j in range(n):
        r = _floor_root(rem, n - j)
        ranges.append(r)
        rem //= r
    return tuple(ranges)


def equal_sketch_spec(schema: KeySchema, h: int, w: int) -> SketchSpec:
    """Paper baseline (2) (= TCM / gMatrix / reversible-sketch style)."""
    n = schema.modularity
    return SketchSpec(schema, tuple((i,) for i in range(n)), equal_ranges(h, n), w)


def mod_sketch_spec(
    schema: KeySchema,
    partition: Sequence[Sequence[int]],
    ranges: Sequence[int],
    w: int,
) -> SketchSpec:
    return SketchSpec(
        schema,
        tuple(tuple(int(m) for m in g) for g in partition),
        tuple(int(r) for r in ranges),
        w,
    )


# --------------------------------------------------------------------------
# Params & state
# --------------------------------------------------------------------------

class SketchParams(NamedTuple):
    """Hash parameters: one CW vector hash per (row, group), int64."""
    q: torch.Tensor  # int64[w, total_chunks]
    r: torch.Tensor  # int64[w, n_groups]


class SketchState(NamedTuple):
    params: SketchParams
    table: torch.Tensor  # [w, h]


def init_params(spec: SketchSpec, generator: torch.Generator,
                device: DeviceLike = None) -> SketchParams:
    q = draw_hash_params(generator, (spec.width, spec.schema.total_chunks), device)
    r = draw_hash_params(generator, (spec.width, spec.n_groups), device)
    return SketchParams(q=q, r=r)


def resolve_params(spec: SketchSpec, params, device: DeviceLike = None) -> SketchParams:
    """Hash params for ``spec`` from a ``torch.Generator`` (a fresh draw) or
    a ``(q, r)`` pair of numpy arrays or tensors -- the port's stand-in for
    the reference's ``key`` argument, since a torch generator cannot
    reproduce a ``jax.random`` draw."""
    device = resolve_device(device)
    if isinstance(params, torch.Generator):
        return init_params(spec, params, device)
    q, r = params
    out = SketchParams(q=as_index_tensor(q, device), r=as_index_tensor(r, device))
    want_q = (spec.width, spec.schema.total_chunks)
    want_r = (spec.width, spec.n_groups)
    if tuple(out.q.shape) != want_q or tuple(out.r.shape) != want_r:
        raise ValueError(
            f"hash params have shapes q{tuple(out.q.shape)} r{tuple(out.r.shape)}, "
            f"the spec needs q{want_q} r{want_r}")
    return out


def init_state(spec: SketchSpec, params, dtype=torch.int32,
               device: DeviceLike = None) -> SketchState:
    params = resolve_params(spec, params, device)
    table = torch.zeros((spec.width, spec.table_size), dtype=dtype,
                        device=params.q.device)
    return SketchState(params=params, table=table)


def as_freqs(freqs, device: torch.device) -> torch.Tensor:
    """A frequency block (numpy or tensor) as a tensor on ``device``."""
    if isinstance(freqs, torch.Tensor):
        return freqs.to(device)
    return torch.from_numpy(np.asarray(freqs)).to(device)


# --------------------------------------------------------------------------
# Indexing / update / query
# --------------------------------------------------------------------------

def compute_indices(spec: SketchSpec, params: SketchParams, items) -> torch.Tensor:
    """Cell index per (row, item): int64[w, B].

    items: [B, n_modules] module values (numpy uint32 or an int tensor).
    """
    items = as_index_tensor(items, params.q.device)
    chunks = spec.schema.module_chunks(items)                 # [B, C]
    idx = torch.zeros((spec.width, chunks.shape[0]), dtype=torch.int64,
                      device=chunks.device)
    for j, (rng_j, stride_j) in enumerate(zip(spec.ranges, spec.strides)):
        cols = list(spec.group_chunk_columns(j))
        hj = cw_hash(chunks[None, :, cols], params.q[:, None, cols],
                     params.r[:, j, None])                    # [w, B]
        idx += (hj % int(rng_j)) * int(stride_j)
    return idx


def compute_indices_np(spec: SketchSpec, params: SketchParams, items: np.ndarray) -> np.ndarray:
    """Host oracle for compute_indices (uint64 arithmetic)."""
    chunks = spec.schema.module_chunks_np(np.asarray(items))
    q = np.asarray(params.q.cpu() if isinstance(params.q, torch.Tensor) else params.q)
    r = np.asarray(params.r.cpu() if isinstance(params.r, torch.Tensor) else params.r)
    w = spec.width
    idx = np.zeros((w, chunks.shape[0]), dtype=np.uint64)
    for j, (rng_j, stride_j) in enumerate(zip(spec.ranges, spec.strides)):
        cols = list(spec.group_chunk_columns(j))
        for k in range(w):
            hk = cw_hash_np(chunks[:, cols], q[k, cols], int(r[k, j]))
            idx[k] += (hk.astype(np.uint64) % np.uint64(rng_j)) * np.uint64(stride_j)
    return idx.astype(np.uint32)


def add_at_indices_(table: torch.Tensor, idx: torch.Tensor,
                    freqs) -> torch.Tensor:
    """Scatter-add ``freqs`` into ``table`` IN PLACE at per-row cell indices.

    idx: int64[w, B] (one cell per row per item); ``table`` must be
    contiguous.  Flat offsets are int64 (the reference's uint32 offsets
    would wrap past 2^32 cells).  Integer addition is associative, so the
    result equals the reference scatter bit for bit, wraparound included.
    """
    w, h = table.shape
    rows = torch.arange(w, dtype=torch.int64, device=table.device)[:, None]
    flat = (rows * h + idx).reshape(-1)
    f = as_freqs(freqs, table.device).to(table.dtype)
    table.view(-1).index_add_(0, flat, f.expand(w, f.shape[0]).reshape(-1))
    return table


def add_at_indices(table: torch.Tensor, idx: torch.Tensor, freqs) -> torch.Tensor:
    """Out-of-place :func:`add_at_indices_` (the reference's pure scatter)."""
    return add_at_indices_(table.clone(), idx, freqs)


def update(spec: SketchSpec, state: SketchState, items, freqs) -> SketchState:
    """Fold a block of (item, freq) pairs into a copy of the sketch."""
    idx = compute_indices(spec, state.params, items)          # [w, B]
    return SketchState(params=state.params,
                       table=add_at_indices(state.table, idx, freqs))


def update_jit(spec: SketchSpec, state: SketchState, items, freqs) -> SketchState:
    """In-place :func:`update` (the reference donates the table here)."""
    idx = compute_indices(spec, state.params, items)
    add_at_indices_(state.table, idx, freqs)
    return state


def query(spec: SketchSpec, state: SketchState, items) -> torch.Tensor:
    """Count-Min style point query: min over rows (overestimate)."""
    idx = compute_indices(spec, state.params, items)          # [w, B]
    vals = torch.gather(state.table, 1, idx)
    return vals.min(dim=0).values


def merge(a: SketchState, b: SketchState) -> SketchState:
    """Cell-wise merge: sketch(A + B) == merge(sketch(A), sketch(B)) exactly."""
    return SketchState(params=a.params, table=a.table + b.table)


def group_hash(spec: SketchSpec, params: SketchParams, group: int,
               values) -> torch.Tensor:
    """The CW hash of ``values`` under ``group``'s params: int64[w, Q] in
    [0, P31).

    ``values``: [Q, len(group modules)] module values for the group.  Its
    residue mod the group's range is the bucket factor
    (:func:`group_subindex`); under the sign params its low bit is the sign
    factor (``countsketch.group_sign_parity``).
    """
    values = as_index_tensor(values, params.q.device)
    vcols = []
    for mi, mod in enumerate(spec.partition[group]):
        for c in range(spec.schema.chunk_counts[mod]):
            vcols.append((values[:, mi] >> (16 * c)) & 0xFFFF)
    gchunks = torch.stack(vcols, dim=-1)                      # [Q, Cg]
    cols = list(spec.group_chunk_columns(group))
    return cw_hash(gchunks[None], params.q[:, None, cols],
                   params.r[:, group, None])                  # [w, Q]


def group_subindex(spec: SketchSpec, params: SketchParams, group: int,
                   values) -> torch.Tensor:
    """Sub-index of ``values`` within ``group``'s hash range: int64[w, Q].

    ``values``: [Q, len(group modules)] module values for the group.  This
    is the per-group factor of the mixed-radix cell address, from which
    the hierarchy's separable candidate queries are built.
    """
    return group_hash(spec, params, group, values) % int(spec.ranges[group])


# --------------------------------------------------------------------------
# Streaming builds
# --------------------------------------------------------------------------

def stream_blocks(items, freqs, block: int):
    """Yield a weighted stream as fixed-size numpy blocks.

    Short tails are zero-padded (zero-frequency items are no-ops under
    ``update``), exactly as the reference pads them.
    """
    items = np.asarray(items, dtype=np.uint32)
    freqs = np.asarray(freqs)
    n = items.shape[0]
    for s in range(0, n, block):
        e = min(n, s + block)
        blk_items = items[s:e]
        blk_freqs = freqs[s:e]
        if e - s < block and n > block:
            pad = block - (e - s)
            blk_items = np.pad(blk_items, ((0, pad), (0, 0)))
            blk_freqs = np.pad(blk_freqs, (0, pad))
        yield blk_items, blk_freqs


def build_sketch(
    spec: SketchSpec,
    params,
    items,
    freqs,
    block: int = 1 << 18,
    dtype=torch.int32,
    device: DeviceLike = None,
) -> SketchState:
    """Build a sketch over a (possibly large) weighted stream, in blocks.

    ``params``: a ``torch.Generator`` or a ``(q, r)`` pair (see
    :func:`resolve_params`)."""
    state = init_state(spec, params, dtype=dtype, device=device)
    for blk_items, blk_freqs in stream_blocks(items, freqs, block):
        state = update_jit(spec, state, blk_items, blk_freqs)
    return state
