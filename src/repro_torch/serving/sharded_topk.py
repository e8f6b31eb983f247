"""Sharded heavy-hitter serving on a device mesh, PyTorch port of
``repro/serving/sharded_topk.py``.

:class:`ShardedTopKService` runs the hierarchical heavy-hitter pipeline
(core/hierarchy.py) over the data axes of a
:class:`~repro_torch.launch.mesh.Mesh`:

  ingest   the block is split over the data axes and every shard folds its
           slice into its *local* buffer of all levels on its device
           (core.distributed.lazy_hierarchy_update: one K3 launch a shard on
           the card, each item hashed once and every level's cell derived
           by the cascade; no collective on the ingest path), while
           per-shard space-saving pools (core/summary.py) admit candidate
           group values;
  sync     at sync points the local buffers are psum-merged
           (core.distributed.merge_local_hierarchy, exact by linearity) into
           the serving tables and zeroed in place; the shard pools fold into
           global pools with the mergeable-summaries rule
           (SpaceSaving.fold) when a query next reads them;
  query    ``heavy_hitters`` / ``topk`` run the threshold descent
           (core.hierarchy.find_heavy_hitters; K4 on the card) against the
           merged tables.

The merged tables live on the mesh's first device and the queries run
there; the reference replicates them over the mesh.  Nothing in any output
depends on it.

Shard-count invariance: every level table is linear in the stream and
integer addition is exact and order-free, so the merged tables -- and with
them the query output -- are bit-identical for any shard count and any
split of the same stream.  The candidate pools stay invariant as long as
they are under capacity (the fold is then an exact union); ``candidates()``
sorts rows lexicographically so the descent order never depends on pool
iteration order.

Conservative tables are non-linear and cannot psum: the service refuses
``mode="conservative"``, as do the distributed entry points
(core.distributed.require_linear) and the endpoint's ``to_sharded``.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import distributed as dist
from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.core.summary import SpaceSaving
from repro_torch.device import kernel_switch, numpy_dtype_name
from repro_torch.serving.migration import MigratingSurface, require_not_migrating


def threshold_descent_topk(
    heavy_hitters_fn: Callable[..., Tuple[np.ndarray, np.ndarray]],
    candidates: Sequence[np.ndarray],
    k: int,
    *,
    total: int,
    n_modules: int,
    min_threshold: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k by estimate: geometric threshold descent until k keys found.

    Shared by SketchTopKEndpoint.topk and ShardedTopKService.topk.
    ``min_threshold`` floors the descent; the default scales with the
    stream (total / 2^17) because at threshold ~1 every candidate survives
    every level and the leaf evaluates the full candidate cross-product.
    Pass ``min_threshold=1`` explicitly to force exhaustive descent on
    small candidate pools.
    """
    if min_threshold is None:
        min_threshold = max(1, total >> 17)
    thr = max(total, 1)
    items = np.zeros((0, n_modules), np.uint32)
    est = np.zeros((0,), np.int64)
    while thr >= min_threshold:
        items, est = heavy_hitters_fn(thr, candidates=candidates)
        if len(est) >= k or thr == min_threshold:
            break
        thr = max(min_threshold, thr // 4)
    return items[:k], est[:k]


class ShardedTopKService(MigratingSurface):
    """Heavy-hitter / top-k serving over a data-parallel device mesh.

    One service owns the whole mesh: ``n_shards`` is the product of the
    ``data_axes`` sizes, each shard ingesting a contiguous slice of every
    block.  ``params`` replaces the reference's jax key: a
    ``torch.Generator`` or the finest level's ``(q, r)`` arrays, drawn once
    for all shards and all shard counts (cell-wise sums of differently
    hashed tables would be garbage).

    ``sync_every`` sets the psum cadence: the merge runs after that many
    ingested blocks (1 = synchronous).  ``sync_every=None`` leaves every
    sync point manual; any query syncs first, so results are never stale.
    ``use_kernel=None`` follows the merged tables' device (K4 on the card),
    and is resolved again at every query, so it follows them through
    ``remesh`` too; ``True``/``False`` are kept as given.

    Hot spec migration (serving/migration.py): ``begin_migration`` opens a
    double-write window onto a successor service on the same mesh; the
    successor is itself shard-count invariant, so a migration is
    bit-identical across shard counts end to end.
    """

    def __init__(self, base_spec: sk.SketchSpec, params, mesh, *,
                 data_axes: Optional[Tuple[str, ...]] = None,
                 max_candidates_per_group: int = 1 << 16,
                 sync_every: Optional[int] = 1,
                 use_kernel: Optional[bool] = None, dtype=torch.int32,
                 mode: str = "linear"):
        dist.require_linear(mode, "ShardedTopKService")
        from repro_torch.launch.mesh import sketch_data_axes

        self.mode = mode
        self.mesh = mesh
        self.data_axes = tuple(sketch_data_axes(mesh) if data_axes is None else data_axes)
        self.n_shards = mesh.axis_size(self.data_axes)
        self.hspec = hh.HierarchySpec.from_spec(base_spec)
        self._hplan = dist.local_plan(self.hspec)
        self.merged = hh.init_hierarchy(self.hspec, params, dtype=dtype,
                                        device=mesh.first_device)
        self._dtype = dtype
        self._local = self._fresh_locals()
        self.max_candidates = int(max_candidates_per_group)
        self._use_kernel = use_kernel
        self.sync_every = sync_every
        self._migration = None
        self.total = 0
        self._blocks_since_sync = 0
        self._dirty = False
        self._pools_dirty = False
        self._shard_pools: List[List[SpaceSaving]] = [
            self._fresh_pools() for _ in range(self.n_shards)]
        self._global_pools: List[SpaceSaving] = self._fresh_pools()

    def _fresh_pools(self) -> List[SpaceSaving]:
        return [SpaceSaving(self.max_candidates, len(g))
                for g in self.hspec.base.partition]

    def _fresh_locals(self) -> List[torch.Tensor]:
        """Zero local buffers of all levels, one on each shard's device."""
        return dist.init_local_tables(
            self.mesh, self.data_axes, self.n_shards,
            (self.hspec.base.width, self._hplan.padded_cols), self._dtype)

    @property
    def device(self) -> torch.device:
        """Where the merged tables live and the queries run."""
        return self.mesh.first_device

    @property
    def use_kernel(self) -> bool:
        """Whether the descent runs on K4: the caller's switch, resolved
        against where the merged tables are now."""
        return kernel_switch(self._use_kernel, self.device)

    # -- ingest (per-shard lazy fold, no collective) ------------------------

    def ingest(self, items: np.ndarray,
               freqs: Optional[np.ndarray] = None) -> None:
        """Fold a weighted key block, sharded over the mesh's data axes.

        The block is padded so every shard sees the same power-of-two row
        count (zero-frequency pad rows are no-ops in the linear update and
        are skipped by the pools), then each shard folds its contiguous
        slice into its local buffer; no collective until the next sync.
        """
        items = np.asarray(items, dtype=np.uint32)
        if items.shape[0] == 0:
            return
        if freqs is None:
            freqs = np.ones(items.shape[0], dtype=np.int64)
        freqs = np.asarray(freqs)
        self.total += int(freqs.sum())
        raw_items, raw_freqs = items, freqs
        items, freqs, per = dist.pad_block_pow2(items, freqs, self.n_shards)
        for s in range(self.n_shards):
            sl = slice(s * per, (s + 1) * per)
            for j, g in enumerate(self.hspec.base.partition):
                self._shard_pools[s][j].offer(items[sl][:, list(g)], freqs[sl])
        dist.lazy_hierarchy_update(self.hspec, self.mesh, self.data_axes, self._local,
                                   self.merged.states[-1].params, items, freqs,
                                   hplan=self._hplan)
        self._dirty = True
        self._pools_dirty = True
        self._blocks_since_sync += 1
        if self.sync_every and self._blocks_since_sync >= self.sync_every:
            self.sync()
        # double-write window: the successor pads and splits the RAW block
        # itself, exactly like a fresh service would
        self._migration_tick(raw_items, raw_freqs)

    # -- hot spec migration hooks (serving/migration.MigratingSurface) ------

    def _build_successor(self, new_spec: sk.SketchSpec,
                         params) -> "ShardedTopKService":
        """A fresh service on ``new_spec`` over the SAME mesh and data axes
        (same pool capacity, sync cadence, kernel switch, table dtype)."""
        return ShardedTopKService(
            new_spec, params, self.mesh, data_axes=self.data_axes,
            max_candidates_per_group=self.max_candidates,
            sync_every=self.sync_every, use_kernel=self._use_kernel,
            dtype=self._dtype)

    def _adopt(self, inc: "ShardedTopKService") -> None:
        """Adopt the successor's state wholesale; the old tables, locals and
        pools lose their last references."""
        self.hspec = inc.hspec
        self._hplan = inc._hplan
        self.merged = inc.merged
        self._local = inc._local
        self._dirty = inc._dirty
        self._pools_dirty = inc._pools_dirty
        self._blocks_since_sync = inc._blocks_since_sync
        self._shard_pools = inc._shard_pools
        self._global_pools = inc._global_pools
        self.total = inc.total

    # -- sync (explicit psum point) -----------------------------------------

    def sync(self) -> None:
        """psum-merge the local deltas into the serving tables, then zero
        the locals in place.  Exact by linearity.  The candidate-pool fold
        waits for the first query that reads ``candidates()``."""
        if not self._dirty:
            return
        deltas = dist.merge_local_hierarchy(self.mesh, self.data_axes, self._local,
                                            self._hplan)
        for st, d in zip(self.merged.states, deltas):
            st.table.add_(d)
        for buf in self._local:
            buf.zero_()
        self._dirty = False
        self._blocks_since_sync = 0

    def _ensure_synced(self) -> None:
        if self._dirty:
            self.sync()

    # -- elastic N->M re-meshing --------------------------------------------

    def remesh(self, new_mesh, *,
               data_axes: Optional[Tuple[str, ...]] = None) -> None:
        """Move this service onto a different mesh (grow or shrink), live.

        Exact by linearity, no drain needed: ``sync()`` merges every shard's
        local deltas into the serving tables, which are then COPIED onto
        the new mesh's first device (training/fault_tolerance.elastic_remesh),
        with fresh zero locals on the new shards' devices.  Queries before
        and after agree bit for bit at any N -> M.  Candidate pools fold
        into the new shard 0 (exact union under capacity); later ingest
        fills all M shards' pools.  Refused mid-migration.
        """
        from repro_torch.launch.mesh import sketch_data_axes
        from repro_torch.training.fault_tolerance import elastic_remesh

        require_not_migrating(self._migration, "ShardedTopKService.remesh")
        self.sync()
        data_axes = tuple(sketch_data_axes(new_mesh) if data_axes is None else data_axes)
        folded = [SpaceSaving.fold([pools[j] for pools in self._shard_pools])
                  for j in range(len(self._global_pools))]
        self.mesh = new_mesh
        self.data_axes = data_axes
        self.n_shards = new_mesh.axis_size(data_axes)
        self.merged = elastic_remesh(self.merged, new_mesh)
        self._local = self._fresh_locals()
        self._shard_pools = [folded] + [self._fresh_pools()
                                        for _ in range(self.n_shards - 1)]
        self._pools_dirty = True
        self._dirty = False
        self._blocks_since_sync = 0

    # -- durable state (serving/recovery.py snapshot currency) ---------------

    def _config_fingerprint(self) -> np.ndarray:
        desc = (f"sharded|{self.hspec.base!r}|mode={self.mode}"
                f"|dtype={numpy_dtype_name(self._dtype)}|cap={self.max_candidates}")
        return np.frombuffer(desc.encode(), dtype=np.uint8).copy()

    def state_dict(self) -> dict:
        """Full service state as a flat ``{key: ndarray}`` mapping, with the
        reference's keys, dtypes and fingerprint (it loads into the
        reference's service and back).

        Syncs first, so the snapshot is the canonical form: merged tables
        hold everything ingested, locals are zero.  The fingerprint leaves
        out the mesh and shard count: a 4-shard snapshot restores into a
        2-shard service."""
        if self._migration is not None:
            raise ValueError(
                "cannot checkpoint a service mid-migration: the warmup "
                "successor's state is transient; call abort_migration() to "
                "roll back to the active surface (or wait for cutover), "
                "then snapshot")
        self.sync()
        fine = self.merged.states[-1].params
        out = {
            "meta.total": np.asarray(self.total, dtype=np.int64),
            "meta.n_shards": np.asarray(self.n_shards, dtype=np.int64),
            "meta.fingerprint": self._config_fingerprint(),
            "params.q": fine.q.cpu().numpy().astype(np.uint32),
            "params.r": fine.r.cpu().numpy().astype(np.uint32),
        }
        for i, st in enumerate(self.merged.states):
            out[f"level{i}.table"] = st.table.cpu().numpy()
        for s, pools in enumerate(self._shard_pools):
            for j, p in enumerate(pools):
                for k, v in p.state_dict().items():
                    out[f"shard{s}.pool{j}.{k}"] = v
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Restore a state saved by :meth:`state_dict` or by the reference's
        service; bit-exact round trip.

        With the saved shard count, every shard's pool is restored in
        place; otherwise all saved pools fold into shard 0 (exact union
        under capacity).  Either way the merged tables, totals and query
        output are bit-identical to the snapshotted service's."""
        fp = self._config_fingerprint()
        got = np.asarray(sd["meta.fingerprint"], dtype=np.uint8)
        if not np.array_equal(fp, got):
            raise ValueError(
                "sharded state_dict fingerprint mismatch: saved "
                f"{bytes(got).decode(errors='replace')!r}, this service is "
                f"{bytes(fp).decode(errors='replace')!r}")
        device = self.device
        base = sk.resolve_params(self.hspec.levels[-1], (sd["params.q"], sd["params.r"]),
                                 device)
        self.merged = hh.HierarchyState(states=tuple(
            sk.SketchState(params=hh.level_params(self.hspec, base, i),
                           table=torch.from_numpy(np.array(sd[f"level{i}.table"])).to(device))
            for i in range(self.hspec.n_levels)))
        for buf in self._local:
            buf.zero_()
        self.total = int(sd["meta.total"])
        self._dirty = False
        self._blocks_since_sync = 0
        saved_shards = int(sd["meta.n_shards"])

        def load_pool(s: int, j: int) -> SpaceSaving:
            p = SpaceSaving(self.max_candidates, len(self.hspec.base.partition[j]))
            p.load_state(sd[f"shard{s}.pool{j}.rows"], sd[f"shard{s}.pool{j}.counts"],
                         sd[f"shard{s}.pool{j}.errs"])
            return p

        n_groups = len(self.hspec.base.partition)
        if saved_shards == self.n_shards:
            self._shard_pools = [[load_pool(s, j) for j in range(n_groups)]
                                 for s in range(saved_shards)]
        else:
            folded = [SpaceSaving.fold([load_pool(s, j) for s in range(saved_shards)])
                      for j in range(n_groups)]
            self._shard_pools = [folded] + [self._fresh_pools()
                                            for _ in range(self.n_shards - 1)]
        self._pools_dirty = True

    # -- queries (descent against the merged level tables) ------------------

    def state(self) -> hh.HierarchyState:
        """The merged (serving) hierarchy state, on the mesh's first device."""
        self._ensure_synced()
        return self.merged

    def candidates(self) -> List[np.ndarray]:
        """Per-group candidate arrays from the folded global pools, rows
        sorted lexicographically (np.unique) so the descent -- and top-k tie
        order -- never depends on the folded pools' dict order, which varies
        with the shard count.  The global pools are re-folded from the
        cumulative shard pools when ingest has run since the last fold."""
        self._ensure_synced()
        if self._pools_dirty:
            self._global_pools = [
                SpaceSaving.fold([pools[j] for pools in self._shard_pools])
                for j in range(len(self._global_pools))]
            self._pools_dirty = False
        out = []
        for p in self._global_pools:
            vals = p.values()
            out.append(np.unique(vals, axis=0) if len(vals) else vals)
        return out

    def heavy_hitters(self, threshold: int,
                      candidates: Optional[List[np.ndarray]] = None,
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Every key estimated >= threshold, from the merged tables."""
        self._ensure_synced()
        if candidates is None:
            candidates = self.candidates()
        return hh.find_heavy_hitters(self.hspec, self.merged, threshold, candidates,
                                     use_kernel=self.use_kernel)

    def topk(self, k: int, min_threshold: Optional[int] = None,
             ) -> Tuple[np.ndarray, np.ndarray]:
        self._ensure_synced()
        return threshold_descent_topk(
            self.heavy_hitters, self.candidates(), k, total=self.total,
            n_modules=self.hspec.base.schema.modularity,
            min_threshold=min_threshold)
