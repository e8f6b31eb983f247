"""Sketch-based gradient compression with error feedback, PyTorch port of
``repro/training/grad_compression.py``.

Each worker folds a large gradient leaf into a two-level *hierarchical*
signed Count-Sketch (core/countsketch.py) whose keys are modular: a weight
coordinate is the pair (row, col) of its matrix.  A descent then finds the
heavy coordinates: level 0 estimates every row prefix, a beam of the
heaviest rows survives (or every row, when level 0 cannot rank rows), the
finest level's [beam, cols] candidate grid is dequeried, and an exact top-k
picks k coordinates.  Their exact values are sent; the rest goes into an
error-feedback residual re-injected next step (EF-SGD).  Leaves below
``min_size`` pass through uncompressed.

On the card the fold of each leaf is ONE K8f launch
into one fresh table
(``countsketch.hier_fold_zero_tables``), and the descent's candidate gather is
the plain gather (``hier_candidate_query_signed_ref``), as in the
reference, whose K9 takes int32 tables only.  Top-k selections are
``jax.lax.top_k``'s: the k largest, the lower index first among ties
(a stable descending sort), so the same coordinates come back in both
packages.

Hash params cannot come from a jax key: :func:`init_compression` draws them
from a ``torch.Generator`` leaf by leaf, in the reference's leaf order, or
takes each leaf's ``(q, r, sign_q, sign_r)`` arrays (e.g. the reference's
own draw, ``repro_torch.interop.compression_state_from_numpy``).

With ``axis_name`` set, :func:`compress_decompress` performs the whole
data-parallel reduction over replicas stacked on a leading axis, as
``jax.pmap`` takes them (:func:`replicate_state` stacks a state's
residuals): each replica's tables are folded by K8f, then pmean'd (a sum in
replica order, then a division by n, as the reference's ``pmean``), one
descent runs on the merged tables, the k selected values are pmean'd, and
passthrough leaves are pmean'd.  Every replica comes back with the same
values, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch import tree as tr
from repro_torch.core import countsketch as cs
from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.core.hashing import KeySchema
from repro_torch.kernels.hier_query import hier_candidate_query_signed_ref

PyTree = Any


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    enabled: bool = False
    width: int = 3            # sketch rows (median estimator)
    ratio: float = 16.0       # target N / (w*h) cell compression
    min_size: int = 1 << 14   # leaves smaller than this pass through
    beta_rows_cols: float = 1.0  # MOD range split ratio between (row, col)
    k: Optional[int] = None   # heavy coords kept per leaf (None: h // 4)
    beam_factor: int = 2      # descent keeps min(rows, beam_factor * k) rows
    axis_name: Optional[str] = None  # DP axis: all-reduce TABLES, not grads


def _leaf_dims(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """(rows, cols) of a leaf flattened to 2D: all-but-last x last axis."""
    rows = math.prod(shape[:-1]) if len(shape) > 1 else 1
    cols = int(shape[-1])
    return rows, cols


def _leaf_schema(shape: Tuple[int, ...]) -> KeySchema:
    """Coordinates of a leaf as a modularity-2 (row, col) key."""
    rows, cols = _leaf_dims(shape)
    return KeySchema(domains=(max(2, rows), max(2, cols)))


def _leaf_spec(cfg: CompressionConfig, shape: Tuple[int, ...]) -> sk.SketchSpec:
    """Per-leaf finest-level spec with ``prod(ranges) <= h``: a is the
    floored beta-weighted square root, b the floor of the remaining budget,
    both clamped to their module's domain."""
    rows, cols = _leaf_dims(shape)
    n = rows * cols
    h = max(64, int(n / (cfg.ratio * cfg.width)))
    a = int((h * cfg.beta_rows_cols) ** 0.5)
    a = max(2, min(a, h // 2, max(2, rows)))
    b = max(2, min(h // a, max(2, cols)))
    return sk.mod_sketch_spec(_leaf_schema(shape), [(0,), (1,)], (a, b),
                              cfg.width)


def _coords(shape: Tuple[int, ...], device) -> torch.Tensor:
    """int32[N, 2] (row, col) coordinates of a leaf: 8 bytes a coordinate,
    as the reference's uint32 pairs (every leaf has fewer than 2^31 rows and
    columns)."""
    rows, cols = _leaf_dims(shape)
    r = torch.arange(rows, dtype=torch.int32, device=device)
    c = torch.arange(cols, dtype=torch.int32, device=device)
    return torch.stack([r.repeat_interleave(cols), c.repeat(rows)], dim=-1)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """Static per-leaf geometry, frozen at init."""
    hspec: hh.HierarchySpec
    shape: Tuple[int, ...]
    rows: int
    cols: int
    k: int                    # exact number of coordinates kept
    beam: int                 # rows surviving the level-0 descent


def _leaf_plan(cfg: CompressionConfig, shape: Tuple[int, ...]) -> LeafPlan:
    spec = _leaf_spec(cfg, shape)
    rows, cols = _leaf_dims(shape)
    k = spec.table_size // 4 if cfg.k is None else int(cfg.k)
    k = max(1, min(k, rows * cols))
    # k heavy coords occupy at most k distinct rows, so a beam of
    # beam_factor * k rows keeps every heavy row -- provided level 0 can
    # rank rows at all.  When the row range is narrower than the row
    # domain, several rows share every level-0 cell, and the plan falls
    # back to beam == rows (the full grid, no false negatives).
    if spec.ranges[0] >= rows and k < rows:
        beam = max(1, min(rows, cfg.beam_factor * k))
    else:
        beam = rows
    return LeafPlan(hspec=hh.HierarchySpec.from_spec(spec),
                    shape=tuple(int(s) for s in shape),
                    rows=rows, cols=cols, k=k, beam=beam)


@dataclasses.dataclass
class LeafCompressor:
    """One leaf's frozen plan, hash draw and coordinate keys.  The arrays
    are ``params`` and ``coords`` (what a checkpoint stores, as the
    reference's pytree children); the plan is static."""
    _tree_fields = ("params", "coords")

    plan: LeafPlan
    params: cs.CountSketchParams
    coords: torch.Tensor      # int32[N, 2]


class CompressionState(NamedTuple):
    residual: PyTree          # error-feedback memory (None for passthrough)
    compressors: PyTree       # per-leaf LeafCompressor (None for passthrough)


Draws = Union[torch.Generator, Mapping[tr.Path, Tuple[Any, Any, Any, Any]]]


def init_compression(cfg: CompressionConfig, params: PyTree,
                     draws: Draws) -> CompressionState:
    """Residuals and compressors for every leaf of ``params``, on the
    leaves' device.  ``draws``: a ``torch.Generator`` (a fresh draw per
    compressed leaf, in the reference's leaf order) or, per compressed
    leaf's path, its finest level's ``(q, r, sign_q, sign_r)`` arrays."""
    residual, comps = [], []
    for path, p in tr.flatten(params):
        if p.numel() >= cfg.min_size:
            plan = _leaf_plan(cfg, tuple(p.shape))
            src = draws if isinstance(draws, torch.Generator) else draws[path]
            cparams = cs.resolve_params(plan.hspec.levels[-1], src, p.device)
            residual.append((path, torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)))
            comps.append((path, LeafCompressor(plan, cparams,
                                               _coords(plan.shape, p.device))))
        else:
            residual.append((path, None))
            comps.append((path, None))
    return CompressionState(residual=tr.unflatten(residual),
                            compressors=tr.unflatten(comps))


def _top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of 1-D ``x``, as ``jax.lax.top_k``
    returns them: descending, the lower index first among ties."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def _descend_topk(plan: LeafPlan, params: cs.CountSketchParams,
                  tables: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Exact-k heavy-coordinate selection by hierarchy descent: int64[k]
    flat (row * cols + col) indices, k distinct."""
    hspec = plan.hspec
    device = tables[0].device
    hstate = cs.CountSketchHierarchy(params, tables)
    if plan.beam >= plan.rows:
        # Dense fallback (level 0 cannot rank rows, or k >= rows): the
        # grid covers every row, so skip the level-0 query entirely.
        top_rows = torch.arange(plan.rows, dtype=torch.int64, device=device)
    else:
        row_ids = torch.arange(plan.rows, dtype=torch.int64, device=device)[:, None]
        row_est = cs.hier_query(hspec, hstate, 0, row_ids)        # [rows]
        top_rows = _top_k(torch.abs(row_est), plan.beam)

    col_ids = torch.arange(plan.cols, dtype=torch.int64, device=device)[:, None]
    pp, cp, sp, sc = cs.candidate_signed_partials(
        hspec, params, 1, top_rows[:, None], col_ids)
    per_row = hier_candidate_query_signed_ref(tables[1], pp, cp, sp, sc)
    grid = cs.median_rows(per_row)                            # [beam, cols]

    flat = _top_k(torch.abs(grid).reshape(-1), plan.k)       # [k]
    bi = flat // plan.cols
    ci = flat % plan.cols
    return top_rows[bi] * plan.cols + ci


def pmean(xs) -> torch.Tensor:
    """The mean of the replicas ``xs`` (a sequence, or a tensor's slices
    along axis 0) as the reference's ``jax.lax.pmean`` computes it: the
    sum, in replica order, then a division by the replica count.  One
    replica comes back as it is."""
    if len(xs) == 1:
        return xs[0]
    total = xs[0].clone()
    for x in xs[1:]:
        total += x
    return total / len(xs)


def _replicated(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` repeated on a new leading axis of n replicas (a view at n = 1)."""
    return x.unsqueeze(0).expand(n, *x.shape).contiguous()


def _compress_leaf(comp: LeafCompressor, g: torch.Tensor, r: torch.Tensor):
    """One leaf over n replicas stacked on axis 0: (dense float32 output,
    the same on every replica, [n, ...]; each replica's new residual).

    Each replica's corrected gradient is folded into its own tables (K8f),
    the tables are pmean'd, ONE descent selects k coordinates on them, and
    the replicas' exact values there are pmean'd, so that
    ``corrected == dense + residual`` exactly at n = 1."""
    plan, n = comp.plan, g.shape[0]
    corrected = g.to(torch.float32) + r
    vals = corrected.reshape(n, -1)
    per_replica = [cs.hier_fold_zero_tables(plan.hspec, comp.params, comp.coords, v)
                   for v in vals]
    tables = tuple(pmean(level) for level in zip(*per_replica))
    coord_flat = _descend_topk(plan, comp.params, tables)
    dense = torch.zeros_like(vals[0])
    dense[coord_flat] = pmean(vals[:, coord_flat])
    dense = _replicated(dense, n)
    return dense.reshape(g.shape), (vals - dense).reshape(g.shape)


def compress_decompress(
    cfg: CompressionConfig,
    grads: PyTree,
    state: CompressionState,
) -> Tuple[PyTree, CompressionState, Dict[str, torch.Tensor]]:
    """grad -> sketch -> descent top-k -> exact values, with error feedback.
    Passthrough leaves come back as they are.  With ``cfg.axis_name`` set,
    ``grads`` and the residuals carry the replicas on a leading axis, the
    result is the full cross-replica reduction and ``compress_rel_err`` has
    one entry a replica: the caller must not all-reduce the gradients
    again.  Without it, the same reduction runs on one replica."""
    if cfg.axis_name is not None:
        return _compress_replicas(grads, state)

    def stacked(x):
        return None if x is None else x[None]

    def first(x):
        return None if x is None else x[0]

    out, st, metrics = _compress_replicas(
        tr.map_leaves(stacked, grads),
        CompressionState(residual=tr.map_leaves(stacked, state.residual),
                         compressors=state.compressors))
    return (tr.map_leaves(first, out),
            CompressionState(residual=tr.map_leaves(first, st.residual),
                             compressors=state.compressors),
            {k: v[0] for k, v in metrics.items()})


def replicate_state(state: CompressionState, n: int) -> CompressionState:
    """``state`` for n data-parallel replicas: every residual stacked n
    times on a leading axis (the compressors' plans, draws and coordinates
    are shared)."""
    return CompressionState(
        residual=tr.map_leaves(
            lambda r: None if r is None else r.unsqueeze(0).repeat(n, *([1] * r.dim())),
            state.residual),
        compressors=state.compressors)


def _compress_replicas(grads: PyTree, state: CompressionState):
    """The compressor over replicas stacked on axis 0: each compressed
    leaf through :func:`_compress_leaf` (each replica keeps its own
    residual), passthrough leaves pmean'd."""
    r_leaves = dict(tr.flatten(state.residual))
    c_leaves = dict(tr.flatten(state.compressors))
    out_g, out_r = [], []
    sq_err = sq_tot = None
    n = 1
    for path, g in tr.flatten(grads):
        r, comp = r_leaves[path], c_leaves[path]
        n = g.shape[0]
        if comp is None:
            out_g.append((path, _replicated(pmean(g), n)))
            out_r.append((path, r))
            continue
        dense, new_r = _compress_leaf(comp, g, r)
        err = torch.stack([torch.sum(torch.square(x)) for x in new_r])
        tot = torch.stack([torch.sum(torch.square(x.to(torch.float32) + y))
                           for x, y in zip(g, r)])
        sq_err = err if sq_err is None else sq_err + err
        sq_tot = tot if sq_tot is None else sq_tot + tot
        out_g.append((path, dense.to(g.dtype)))
        out_r.append((path, new_r))
    if sq_err is None:
        sq_err = sq_tot = torch.zeros(n, dtype=torch.float32)
    metrics = {"compress_rel_err": torch.sqrt(sq_err / (sq_tot + 1e-12))}
    return (tr.unflatten(out_g),
            CompressionState(residual=tr.unflatten(out_r), compressors=state.compressors),
            metrics)


def compression_ratio(cfg: CompressionConfig, params: PyTree) -> float:
    """Achieved comm-bytes ratio over compressed leaves: the bytes a plain
    all-reduce would ship (the leaf's own dtype) over the float32 tables of
    every level plus the 8k-byte second round.  Takes tensors of any
    device, ``meta`` included."""
    raw = comp = 0
    for p in tr.leaves(params):
        if p.numel() >= cfg.min_size:
            plan = _leaf_plan(cfg, tuple(p.shape))
            raw += p.numel() * p.element_size()
            comp += 4 * sum(s.width * s.table_size for s in plan.hspec.levels)
            comp += 8 * plan.k
    return raw / max(1, comp)
