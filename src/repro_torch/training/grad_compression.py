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
own draw, ``repro_torch.interop.compression_state_from_numpy``).  The DP
table all-reduce (``axis_name``) is not ported yet (ROADMAP item 12).
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


def _require_local(cfg: CompressionConfig) -> None:
    if cfg.axis_name is not None:
        raise NotImplementedError(
            "CompressionConfig.axis_name: the DP all-reduce of the sketch "
            "tables is not ported yet (ROADMAP item 12, sharding)")


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
    """One leaf's frozen plan, hash draw and coordinate keys."""
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


def _compress_leaf(cfg: CompressionConfig, comp: LeafCompressor,
                   g: torch.Tensor, r: torch.Tensor):
    """One leaf's sketch -> descent -> exact values: (dense float32 output,
    new residual), with ``corrected == dense + residual`` exactly."""
    plan = comp.plan
    corrected = g.to(torch.float32) + r
    vals = corrected.reshape(-1)
    tables = cs.hier_fold_zero_tables(plan.hspec, comp.params, comp.coords, vals)
    coord_flat = _descend_topk(plan, comp.params, tables)
    dense = torch.zeros_like(vals)
    dense[coord_flat] = vals[coord_flat]
    dense = dense.reshape(g.shape)
    new_r = corrected - dense
    return dense, new_r


def compress_decompress(
    cfg: CompressionConfig,
    grads: PyTree,
    state: CompressionState,
) -> Tuple[PyTree, CompressionState, Dict[str, torch.Tensor]]:
    """grad -> sketch -> descent top-k -> exact values, with error feedback.
    Passthrough leaves come back as they are."""
    _require_local(cfg)
    r_leaves = dict(tr.flatten(state.residual))
    c_leaves = dict(tr.flatten(state.compressors))

    out_g, out_r = [], []
    sq_err = sq_tot = None
    for path, g in tr.flatten(grads):
        r, comp = r_leaves[path], c_leaves[path]
        if comp is None:
            out_g.append((path, g))
            out_r.append((path, r))
            continue
        dense, new_r = _compress_leaf(cfg, comp, g, r)
        err = torch.sum(torch.square(new_r))
        tot = torch.sum(torch.square(g.to(torch.float32) + r))
        sq_err = err if sq_err is None else sq_err + err
        sq_tot = tot if sq_tot is None else sq_tot + tot
        out_g.append((path, dense.to(g.dtype)))
        out_r.append((path, new_r))

    if sq_err is None:
        zero = torch.zeros((), dtype=torch.float32)
        sq_err = sq_tot = zero
    metrics = {"compress_rel_err": torch.sqrt(sq_err / (sq_tot + 1e-12))}
    return (tr.unflatten(out_g),
            CompressionState(residual=tr.unflatten(out_r),
                             compressors=state.compressors),
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
