"""Hierarchical heavy-hitter sketches over composite-hash prefixes.

Port of ``repro/core/hierarchy.py``.  Level L sketches the key restricted
to module groups 0..L of the partition, coarsening one group per level.
A Count-Min estimate at level L that falls below a threshold prunes the
whole subtree, which gives the threshold descent of
:func:`find_heavy_hitters`.

All levels share ONE per-group hash family: :func:`init_hierarchy` draws
the finest level's params once and every level L uses the prefix slices
``q[:, :chunks(g_1..g_{L+1})]`` and ``r[:, :L+1]``.  With shared hashes the
level indices nest exactly,

    idx_L = idx_{m-1} // (r_{L+1} * ... * r_{m-1}),

so one hash pass over the full key yields every level's cell index by an
integer division (:func:`hierarchy_indices`); per-level hashing survives
only as the oracle :func:`update_reference`.

The candidate query is separable within a level,

    idx(prefix, v) = idx_prefix * r_L  +  H_L(v),

so a batched query needs only P prefix partials and C child partials per
row (:func:`candidate_partials`), combined on the card by K4 (int32
tables) or K4f (float32: the decayed window's; kernels/hier_query.py).

Indices are int64 tensors; descent results are numpy, exactly the
reference's ``uint32[K, n_modules]`` / ``int64[K]``.  The ``*_jit`` names
and :func:`fold_indices` update the tables in place (the reference donates
them); :func:`update`, :func:`update_reference`,
:func:`update_conservative` and :func:`merge` return new tables.

The conservative folds share the cascade's one hash pass and then fold
every level sequentially (the row-coupling min keeps the folds per level):
on the card all levels in one K5i launch, one CTA per level
(kernels/sketch_update_conservative.py).  Conservative tables are not
linear in the stream and never enter :func:`merge` or
:func:`sharded_hierarchy_build`, which refuses them.
"""
from __future__ import annotations

import dataclasses
import functools
import weakref
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import sketch as sk
from repro_torch.core.distributed import require_linear
from repro_torch.core.hashing import KeySchema
from repro_torch.device import DeviceLike, as_index_tensor


# --------------------------------------------------------------------------
# Spec
# --------------------------------------------------------------------------

def level_modules(base: sk.SketchSpec, level: int) -> Tuple[int, ...]:
    """Module indices (into the base schema) covered by levels 0..level,
    ordered group-major -- the column order of level items."""
    return tuple(m for g in base.partition[: level + 1] for m in g)


def level_spec(base: sk.SketchSpec, level: int) -> sk.SketchSpec:
    """The SketchSpec of one hierarchy level: groups 0..level of the base,
    with modules renumbered consecutively in group-major order."""
    mods = level_modules(base, level)
    schema = KeySchema(domains=tuple(base.schema.domains[m] for m in mods))
    part: List[Tuple[int, ...]] = []
    pos = 0
    for g in base.partition[: level + 1]:
        part.append(tuple(range(pos, pos + len(g))))
        pos += len(g)
    return sk.SketchSpec(schema, tuple(part), base.ranges[: level + 1],
                         base.width)


@dataclasses.dataclass(frozen=True)
class HierarchySpec:
    """A stack of composite-hash sketches over successive group prefixes."""
    base: sk.SketchSpec
    levels: Tuple[sk.SketchSpec, ...]

    @staticmethod
    def from_spec(base: sk.SketchSpec) -> "HierarchySpec":
        return HierarchySpec(
            base=base,
            levels=tuple(level_spec(base, l) for l in range(base.n_groups)),
        )

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def table_cells(self) -> int:
        """Total cells across all levels."""
        return sum(s.width * s.table_size for s in self.levels)

    @functools.cached_property
    def _level_cols(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(tuple(level_modules(self.base, l))
                     for l in range(self.n_levels))

    @functools.cached_property
    def level_divisors(self) -> Tuple[int, ...]:
        """``idx_L = idx_finest // level_divisors[L]`` -- the suffix range
        products of the mixed radix (divisor of the finest level is 1)."""
        divs, d = [], 1
        for r in reversed(self.base.ranges):
            divs.append(d)
            d *= int(r)
        return tuple(reversed(divs))

    def level_items(self, level: int, items):
        """Select/reorder full-key columns into level ``level``'s layout
        (numpy arrays or tensors)."""
        return items[:, list(self._level_cols[level])]

    def to_schema_order(self, items: np.ndarray) -> np.ndarray:
        """Group-major full-key columns -> original schema module order."""
        mods = self._level_cols[self.n_levels - 1]
        out = np.empty_like(items)
        for pos, m in enumerate(mods):
            out[:, m] = items[:, pos]
        return out


class HierarchyState(NamedTuple):
    states: Tuple[sk.SketchState, ...]   # one per level, coarse -> fine


def level_params(hspec: HierarchySpec, base_params: sk.SketchParams,
                 level: int) -> sk.SketchParams:
    """Level ``level``'s hash params as prefix slices of the finest level's."""
    nc = hspec.levels[level].schema.total_chunks
    return sk.SketchParams(q=base_params.q[:, :nc],
                           r=base_params.r[:, : level + 1])


def init_hierarchy(hspec: HierarchySpec, params, dtype=torch.int32,
                   device: DeviceLike = None) -> HierarchyState:
    """ONE shared per-group hash family and zero tables for all levels.

    ``params``: a ``torch.Generator`` (a fresh draw of the finest level's
    params) or the finest level's ``(q, r)`` arrays, e.g. the reference's
    own draw, so both packages hash identically."""
    base_params = sk.resolve_params(hspec.levels[-1], params, device)
    states = []
    for l, spec_l in enumerate(hspec.levels):
        states.append(sk.SketchState(
            params=level_params(hspec, base_params, l),
            table=torch.zeros((spec_l.width, spec_l.table_size), dtype=dtype,
                              device=base_params.q.device)))
    return HierarchyState(states=tuple(states))


def params_share_prefix(state: HierarchyState) -> bool:
    """True iff every level's params are the prefix slices of the finest
    level's -- the precondition of every cascade path."""
    fine = state.states[-1].params
    for l, st in enumerate(state.states):
        q, r = st.params.q, st.params.r
        if q.shape[1] > fine.q.shape[1] or r.shape[1] != l + 1:
            return False
        if not (torch.equal(q, fine.q[:, : q.shape[1]])
                and torch.equal(r, fine.r[:, : l + 1])):
            return False
    return True


_validated_params = weakref.WeakValueDictionary()  # id(q_fine) -> q_fine


def _require_shared_params(state: HierarchyState, entry: str) -> None:
    """Refuse non-shared-params states on the cascade entry points.

    The cascade derives coarse-level cells from the finest index by
    division, which is garbage for independently drawn per-level params.
    Validated once per distinct finest-params tensor (params persist
    across blocks, so streaming ingest pays the check a single time)."""
    q = state.states[-1].params.q
    if _validated_params.get(id(q)) is q:
        return
    if not params_share_prefix(state):
        raise ValueError(
            f"{entry} requires the shared per-group hash family (level "
            "params must be prefix slices of the finest level's, as drawn "
            "by init_hierarchy); for independently drawn per-level params "
            "use update_reference")
    _validated_params[id(q)] = q


# --------------------------------------------------------------------------
# Stream ops (linear => mergeable)
# --------------------------------------------------------------------------

def hierarchy_indices(hspec: HierarchySpec, fine_params: sk.SketchParams,
                      items) -> Tuple[torch.Tensor, ...]:
    """Every level's cell indices from ONE hash pass: tuple of int64[w, B].

    The finest level's composite index on the group-major columns, and each
    coarser level by ``idx_L = idx_finest // prod(r_{L+1}..r_{m-1})``."""
    fine = hspec.levels[-1]
    items = as_index_tensor(items, fine_params.q.device)
    idx_fine = sk.compute_indices(
        fine, fine_params, hspec.level_items(hspec.n_levels - 1, items))
    return tuple(idx_fine // div if div > 1 else idx_fine
                 for div in hspec.level_divisors)


def update(hspec: HierarchySpec, state: HierarchyState,
           items, freqs) -> HierarchyState:
    """Fold a block of full keys into copies of every level (cascade path:
    one hash per (row, item), L scatter-adds)."""
    _require_shared_params(state, "hierarchy.update")
    idxs = hierarchy_indices(hspec, state.states[-1].params, items)
    return HierarchyState(states=tuple(
        sk.SketchState(params=st.params,
                       table=sk.add_at_indices(st.table, idx, freqs))
        for st, idx in zip(state.states, idxs)))


def update_reference(hspec: HierarchySpec, state: HierarchyState,
                     items, freqs) -> HierarchyState:
    """Per-level reference fold: L independent ``sk.update`` calls, each
    re-hashing its prefix from scratch (the parity oracle for the
    cascade)."""
    items = as_index_tensor(items, state.states[-1].params.q.device)
    return HierarchyState(states=tuple(
        sk.update(spec_l, st_l, hspec.level_items(lvl, items), freqs)
        for lvl, (spec_l, st_l) in enumerate(zip(hspec.levels, state.states))))


def update_jit(hspec: HierarchySpec, state: HierarchyState,
               items, freqs) -> HierarchyState:
    """In-place :func:`update` (the reference donates every level table)."""
    _require_shared_params(state, "hierarchy.update_jit")
    idxs = hierarchy_indices(hspec, state.states[-1].params, items)
    return fold_indices(state, idxs, freqs)


def _fold_conservative_(state: HierarchyState, idxs, freqs) -> HierarchyState:
    """Every level's conservative fold at its cascade indices, in place: one
    K5i launch for all levels on the card, the plain loop on the CPU."""
    from repro_torch.kernels.sketch_update_conservative import conservative_fold_tables

    tables = [st.table for st in state.states]
    conservative_fold_tables(tables, idxs, sk.as_freqs(freqs, tables[0].device))
    return state


def update_conservative(hspec: HierarchySpec, state: HierarchyState,
                        items, freqs) -> HierarchyState:
    """Conservative fold into copies of every level (freqs non-negative).

    The index computation shares the one-hash-pass cascade with
    :func:`update`; each level then applies the sequential Estan-Varghese
    fold independently, so every level still never underestimates and the
    descent's no-false-negative argument holds.  The tables are NOT linear
    in the stream: never :func:`merge` them."""
    _require_shared_params(state, "hierarchy.update_conservative")
    idxs = hierarchy_indices(hspec, state.states[-1].params, items)
    copy = HierarchyState(states=tuple(
        sk.SketchState(params=st.params, table=st.table.clone())
        for st in state.states))
    return _fold_conservative_(copy, idxs, freqs)


def update_conservative_jit(hspec: HierarchySpec, state: HierarchyState,
                            items, freqs) -> HierarchyState:
    """In-place :func:`update_conservative` (the reference donates every
    level table)."""
    _require_shared_params(state, "hierarchy.update_conservative_jit")
    idxs = hierarchy_indices(hspec, state.states[-1].params, items)
    return _fold_conservative_(state, idxs, freqs)


def merge(a: HierarchyState, b: HierarchyState) -> HierarchyState:
    """Cell-wise merge per level -- exact by linearity.  Only valid for
    hierarchies built with the linear update: conservative tables are
    excluded, which is why the endpoint's ``merge_from`` refuses them."""
    return HierarchyState(states=tuple(
        sk.merge(sa, sb) for sa, sb in zip(a.states, b.states)))


def build_hierarchy(hspec: HierarchySpec, params, items, freqs,
                    block: int = 1 << 17, dtype=torch.int32,
                    device: DeviceLike = None) -> HierarchyState:
    """Build all levels over a (possibly large) weighted stream, in blocks."""
    state = init_hierarchy(hspec, params, dtype=dtype, device=device)
    for blk_items, blk_freqs in sk.stream_blocks(items, freqs, block):
        state = update_jit(hspec, state, blk_items, blk_freqs)
    return state


# --------------------------------------------------------------------------
# Two-phase ingest (the serving engine's pipeline)
# --------------------------------------------------------------------------

def stage_indices(hspec: HierarchySpec, state: HierarchyState,
                  items) -> Tuple[torch.Tensor, ...]:
    """Pipeline stage A: the hash cascade alone (all levels' cell indices).
    Depends only on the hash params and the block, never on the tables."""
    _require_shared_params(state, "hierarchy.stage_indices")
    return hierarchy_indices(hspec, state.states[-1].params, items)


def fold_indices(state: HierarchyState, idxs: Tuple[torch.Tensor, ...],
                 freqs) -> HierarchyState:
    """Pipeline stage B: fold pre-computed level indices into the tables,
    in place.  ``fold_indices(state, stage_indices(hspec, state, items),
    freqs)`` is bit-identical to ``update_jit(hspec, state, items, freqs)``."""
    for st, idx in zip(state.states, idxs):
        sk.add_at_indices_(st.table, idx, freqs)
    return state


def sharded_hierarchy_build(hspec: HierarchySpec, state: HierarchyState,
                            mesh, data_axes, items, freqs, *,
                            mode: str = "linear") -> HierarchyState:
    """Distributed build: sharded cascade fold + per-level psum (exact).

    Each shard of ``mesh``'s ``data_axes`` hashes its slice of the block
    once and folds it into every level (one K3 launch on its device, K3f
    for float32 levels; core.distributed.sharded_hierarchy_fold), and the
    shards' deltas are psum-merged onto the mesh's first device and added
    to copies of ``state``'s tables there.  ``mode`` exists only to be
    refused: a conservatively built hierarchy has non-linear tables and
    must never enter a psum."""
    from repro_torch.core import distributed as dist

    require_linear(mode, "sharded_hierarchy_build")
    deltas = dist.sharded_hierarchy_fold(
        hspec, state.states[-1].params, mesh, data_axes, items, freqs,
        table_dtypes=tuple(st.table.dtype for st in state.states))
    return HierarchyState(states=tuple(
        sk.SketchState(params=st.params, table=st.table + d.to(st.table.device))
        for st, d in zip(state.states, deltas)))


# --------------------------------------------------------------------------
# Separable candidate queries
# --------------------------------------------------------------------------

def candidate_partials(
    hspec: HierarchySpec,
    state: HierarchyState,
    level: int,
    prefixes,     # [P, n_prefix_modules] (group-major)
    values,       # [C, len(level group modules)]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two factors of the level-``level`` child cell index.

    Returns (pp, cp): int64[w, P] prefix partials (already scaled by the
    last group's range) and int64[w, C] child partials, such that the cell
    index of child (p, c) at row k is ``pp[k, p] + cp[k, c]``."""
    spec_l = hspec.levels[level]
    params = state.states[level].params
    device = params.q.device
    prefixes = as_index_tensor(prefixes, device)
    r_last = spec_l.ranges[-1]

    if level == 0:
        pp = torch.zeros((spec_l.width, prefixes.shape[0]), dtype=torch.int64,
                         device=device)
    else:
        prefix_spec = level_spec(hspec.base, level - 1)
        n_pc = prefix_spec.schema.total_chunks
        prefix_params = sk.SketchParams(q=params.q[:, :n_pc],
                                        r=params.r[:, :level])
        pp = sk.compute_indices(prefix_spec, prefix_params, prefixes)
        pp = pp * int(r_last)

    # child partial: the last group's sub-index, stride 1
    cp = sk.group_subindex(spec_l, params, level, values)
    return pp, cp


def _grid_fns(table: torch.Tensor, use_kernel: bool, span: Optional[int]):
    """(flat, batched) grid evaluators: for a table on the card when asked
    for, the K4f wrappers on float32 and the K4 wrappers otherwise (which
    refuse any dtype but int32), given ``span`` for their window route;
    else the plain versions (any dtype)."""
    from repro_torch.kernels import hier_query as hq

    if use_kernel and table.is_cuda:
        if table.dtype == torch.float32:
            one, batched = hq.hier_candidate_query_f32, hq.hier_candidate_query_f32_batched
        else:
            one, batched = hq.hier_candidate_query, hq.hier_candidate_query_batched
        return (functools.partial(one, span=span), functools.partial(batched, span=span))
    return hq.hier_candidate_query_ref, hq.hier_candidate_query_batched_ref


def candidate_span(hspec: HierarchySpec, level: int) -> int:
    """The query kernels' ``span`` at ``level`` (K4, K9m): the level's last
    range, which every child partial is below (their window route)."""
    return int(hspec.levels[level].ranges[-1])


def candidate_estimates(
    hspec: HierarchySpec,
    state: HierarchyState,
    level: int,
    prefixes: np.ndarray,    # uint32[P, n_prefix_modules]
    values: np.ndarray,      # uint32[C, len(level group modules)]
    *,
    use_kernel: bool = False,
    max_batch: Optional[int] = None,
) -> np.ndarray:
    """CM estimates for every (prefix x candidate-value) child: [P, C].

    ``use_kernel=True`` routes tables on the card through K4 (int32) or K4f
    (float32), and refuses any other dtype there; the default is the plain
    gather.  Both agree bit for bit.  K4 is given the level's last range as its ``span``
    (:func:`candidate_span`).  ``max_batch`` bounds the
    per-call P*C working set: the partials are computed ONCE, then only
    the prefix axis is chunked; a short last chunk is padded with prefix
    partial 0 (always a valid cell) and sliced off.
    """
    pp, cp = candidate_partials(hspec, state, level,
                                np.asarray(prefixes, dtype=np.uint32),
                                np.asarray(values, dtype=np.uint32))
    table = state.states[level].table
    one, _ = _grid_fns(table, use_kernel, candidate_span(hspec, level))

    p, c = pp.shape[1], cp.shape[1]
    if max_batch is None or p * c <= max_batch:
        return one(table, pp, cp).cpu().numpy()
    p_chunk = max(1, max_batch // max(c, 1))
    outs = []
    for s in range(0, p, p_chunk):
        pc = pp[:, s : s + p_chunk]
        if pc.shape[1] < p_chunk:
            pc = torch.nn.functional.pad(pc, (0, p_chunk - pc.shape[1]))
        outs.append(one(table, pc.contiguous(), cp).cpu().numpy())
    return np.concatenate(outs, axis=0)[:p]


# --------------------------------------------------------------------------
# Heavy-hitter descent
# --------------------------------------------------------------------------

def find_heavy_hitters(
    hspec: HierarchySpec,
    state: HierarchyState,
    threshold: float,
    candidates: Sequence[np.ndarray],
    *,
    use_kernel: bool = False,
    max_batch: int = 1 << 16,
) -> Tuple[np.ndarray, np.ndarray]:
    """All keys whose CM estimate is >= ``threshold``.

    candidates[j]: uint32[C_j, len(g_j modules)] -- the value combos to
    consider for group j.  No false negatives for any key whose group
    values appear in the candidate sets.  Returns (items uint32[K,
    n_modules] in schema module order, estimates int64[K]) sorted by
    estimate, descending.  ``use_kernel`` as in :func:`candidate_estimates`.
    """
    if len(candidates) != hspec.n_levels:
        raise ValueError(
            f"need one candidate set per level ({hspec.n_levels}), "
            f"got {len(candidates)}")
    threshold = int(threshold)

    prefixes = np.zeros((1, 0), dtype=np.uint32)
    est = np.zeros((1,), dtype=np.int64)
    for lvl in range(hspec.n_levels):
        cand = np.asarray(candidates[lvl], dtype=np.uint32)
        if cand.ndim != 2 or cand.shape[1] != len(hspec.base.partition[lvl]):
            raise ValueError(
                f"candidates[{lvl}] must be [C, {len(hspec.base.partition[lvl])}]")
        if prefixes.shape[0] == 0 or cand.shape[0] == 0:
            n_mods = len(level_modules(hspec.base, hspec.n_levels - 1))
            return (np.zeros((0, n_mods), np.uint32),
                    np.zeros((0,), np.int64))
        grid = candidate_estimates(
            hspec, state, lvl, prefixes, cand, use_kernel=use_kernel,
            max_batch=max_batch).astype(np.int64)
        keep_p, keep_c = np.nonzero(grid >= threshold)
        prefixes = np.concatenate(
            [prefixes[keep_p], cand[keep_c]], axis=1)
        est = grid[keep_p, keep_c]

    order = np.argsort(-est, kind="stable")
    return hspec.to_schema_order(prefixes[order]), est[order]


# --------------------------------------------------------------------------
# Batched multi-request descent (Q concurrent queries, one launch per level)
# --------------------------------------------------------------------------

def batched_candidate_estimates(
    hspec: HierarchySpec,
    state: HierarchyState,
    level: int,
    prefix_sets: Sequence[np.ndarray],   # Q arrays uint32[P_q, n_prefix_mods]
    values: np.ndarray,                  # uint32[C, len(level group modules)]
    *,
    use_kernel: bool = False,
    max_batch: Optional[int] = None,
) -> List[np.ndarray]:
    """CM estimate grids for Q concurrent requests at one level: Q x [P_q, C].

    The prefix partials are hashed ONCE over the concatenated prefixes,
    padded to a common P_max with prefix partial 0 (sliced off), and the
    whole [Q, P_max, C] grid is evaluated in one launch.  ``max_batch``
    chunks the request axis; ``use_kernel`` as in
    :func:`candidate_estimates`.
    """
    if not prefix_sets:
        return []
    counts = [int(np.asarray(p).shape[0]) for p in prefix_sets]
    if min(counts) == 0:
        raise ValueError("every request must have a non-empty prefix set "
                         "(callers retire empty requests before batching)")
    cat = np.concatenate([np.asarray(p, dtype=np.uint32) for p in prefix_sets],
                         axis=0)
    pp_all, cp = candidate_partials(hspec, state, level, cat,
                                    np.asarray(values, dtype=np.uint32))
    nq, p_max, c = len(counts), max(counts), int(cp.shape[1])

    table = state.states[level].table
    _, batched = _grid_fns(table, use_kernel, candidate_span(hspec, level))

    # per-request column blocks, padded to the common P_max
    blocks, off = [], 0
    for n in counts:
        blk = pp_all[:, off : off + n]
        if n < p_max:
            blk = torch.nn.functional.pad(blk, (0, p_max - n))
        blocks.append(blk)
        off += n
    pp3 = torch.stack(blocks, dim=1)                 # [w, Q, P_max]

    if max_batch is None or nq * p_max * c <= max_batch:
        grids = batched(table, pp3, cp).cpu().numpy()
    else:
        q_chunk = max(1, max_batch // max(p_max * c, 1))
        outs = []
        for s in range(0, nq, q_chunk):
            qc = pp3[:, s : s + q_chunk]
            if qc.shape[1] < q_chunk:
                qc = torch.nn.functional.pad(qc, (0, 0, 0, q_chunk - qc.shape[1]))
            outs.append(batched(table, qc.contiguous(), cp).cpu().numpy())
        grids = np.concatenate(outs, axis=0)[:nq]
    return [grids[i, : counts[i], :] for i in range(nq)]


def batched_find_heavy_hitters(
    hspec: HierarchySpec,
    state: HierarchyState,
    thresholds: Sequence[float],
    candidates: Sequence[np.ndarray],
    *,
    use_kernel: bool = False,
    max_batch: int = 1 << 16,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Q concurrent heavy-hitter descents sharing one set of launches.

    Request q receives exactly ``find_heavy_hitters(..., thresholds[q],
    candidates)``, but the per-level grids of all still-active requests are
    evaluated together.  A request whose prefix set empties retires early
    with the empty result, same as the serial descent.  ``use_kernel`` as
    in :func:`candidate_estimates`.
    """
    if len(candidates) != hspec.n_levels:
        raise ValueError(
            f"need one candidate set per level ({hspec.n_levels}), "
            f"got {len(candidates)}")
    thrs = [int(t) for t in thresholds]
    nq = len(thrs)
    n_mods = len(level_modules(hspec.base, hspec.n_levels - 1))
    empty = (np.zeros((0, n_mods), np.uint32), np.zeros((0,), np.int64))

    prefixes = [np.zeros((1, 0), dtype=np.uint32) for _ in range(nq)]
    est = [np.zeros((1,), dtype=np.int64) for _ in range(nq)]
    done: List[Optional[Tuple[np.ndarray, np.ndarray]]] = [None] * nq
    for lvl in range(hspec.n_levels):
        active = [q for q in range(nq) if done[q] is None]
        if not active:
            break
        cand = np.asarray(candidates[lvl], dtype=np.uint32)
        if cand.ndim != 2 or cand.shape[1] != len(hspec.base.partition[lvl]):
            raise ValueError(
                f"candidates[{lvl}] must be [C, {len(hspec.base.partition[lvl])}]")
        for q in active:
            if prefixes[q].shape[0] == 0 or cand.shape[0] == 0:
                done[q] = empty
        active = [q for q in active if done[q] is None]
        if not active:
            break
        grids = batched_candidate_estimates(
            hspec, state, lvl, [prefixes[q] for q in active], cand,
            use_kernel=use_kernel, max_batch=max_batch)
        for q, grid in zip(active, grids):
            grid = grid.astype(np.int64)
            keep_p, keep_c = np.nonzero(grid >= thrs[q])
            prefixes[q] = np.concatenate(
                [prefixes[q][keep_p], cand[keep_c]], axis=1)
            est[q] = grid[keep_p, keep_c]

    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for q in range(nq):
        if done[q] is not None:
            out.append(done[q])
            continue
        order = np.argsort(-est[q], kind="stable")
        out.append((hspec.to_schema_order(prefixes[q][order]), est[q][order]))
    return out
