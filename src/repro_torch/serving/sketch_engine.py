"""Sketch-serving stack, PyTorch port: the streaming top-k endpoint + the
async engine.

Port of ``repro/serving/sketch_engine.py``, linear and conservative
modes:

:class:`SketchTopKEndpoint`
    the single-shard hierarchical heavy-hitter endpoint -- synchronous
    ingest/query, cross-shard merge, ``state_dict`` interchangeable with
    the reference's.  ``use_update_kernel=True`` folds every block into all
    levels with one K3 launch (kernels/ops.KernelHierarchy);
    ``use_kernel=True`` scores every descent grid with K4.
    ``mode="conservative"`` folds every block with the Estan-Varghese
    update, all levels in one K5i launch on the card; its tables are not
    linear in the stream, so it stays single-shard and refuses every merge
    surface.  Hot spec migration (serving/migration.py's MigratingSurface):
    ``begin_migration`` opens a double-write window onto a fresh successor
    endpoint on a re-tuned spec and cuts over once it has absorbed the
    warmup mass.

:class:`SketchServeEngine`
    the async engine in front of an endpoint or a windowed service
    (serving/windowed_topk.py): staged ingest on the plain path, snapshot
    queries under a staleness bound, batched multi-request descent
    (``submit`` + ``flush``), the epoch clock (``advance``) and the
    auto-tuner (serving/autotune.py), ticked on every ``sync``.

Semantics are the reference's, with one difference of mechanism: where the
reference donates table buffers to jitted folds, the port folds in place.
The snapshot therefore always COPIES the tables -- an aliased snapshot
would see later ingest and silently break the staleness contract.  The
staged fold runs on the current stream; overlapping it with the next
block's hash on a side stream is later performance work.

Not ported yet, and refused by name: ``to_sharded`` and sharded backends
(ROADMAP item 12).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.core.distributed import pad_block_pow2
from repro_torch.core.summary import SpaceSaving
from repro_torch.device import DeviceLike, kernel_switch, numpy_dtype_name
from repro_torch.kernels.ops import KernelHierarchy, check_linear_kernel_freqs
from repro_torch.serving.migration import MigratingSurface, require_not_migrating
from repro_torch.serving.sharded_topk import threshold_descent_topk


# --------------------------------------------------------------------------
# streaming top-k endpoint (hierarchical heavy-hitter sketch)
# --------------------------------------------------------------------------

class SketchTopKEndpoint(MigratingSurface):
    """Serving endpoint for streaming heavy-hitter / top-k queries.

    Ingests weighted key blocks into a hierarchical composite-hash sketch
    (core/hierarchy.py) and answers ``heavy_hitters(threshold)`` and
    ``topk(k)`` without storing the stream.  Admission to the per-group
    candidate pools is weighted space-saving (core/summary.py); the
    descent has no false negatives for keys whose group values are in the
    pools.

    ``mode="conservative"`` applies the Estan-Varghese update per level:
    strictly tighter estimates, but the tables are no longer linear in the
    stream, so such an endpoint refuses ``merge_from`` (both directions),
    ``to_sharded`` and ``stage_block``.  ``use_update_kernel=True`` then
    keeps the per-level conservative folds (K5i), as the reference keeps
    its jnp folds; ``use_kernel=True`` still scores the descent with K4.

    ``params`` replaces the reference's jax key: a ``torch.Generator`` or
    the finest level's ``(q, r)`` arrays (e.g. a reference endpoint's
    ``state_dict()["params.q"]`` / ``["params.r"]``).  ``device=None``
    means ``cuda``.  ``use_kernel``/``use_update_kernel`` left at ``None``
    follow the tables' device (:func:`repro_torch.device.kernel_switch`):
    the kernels on the card, the plain versions on the CPU.
    """

    def __init__(self, base_spec, params, *,
                 max_candidates_per_group: int = 1 << 16,
                 use_kernel: Optional[bool] = None,
                 use_update_kernel: Optional[bool] = None,
                 dtype=torch.int32, mode: str = "linear",
                 device: DeviceLike = None):
        if mode not in ("linear", "conservative"):
            raise ValueError(f"mode must be 'linear' or 'conservative', got {mode!r}")
        self._kh = None
        self._migration = None
        self.hspec = hh.HierarchySpec.from_spec(base_spec)
        self.state = hh.init_hierarchy(self.hspec, params, dtype=dtype,
                                       device=device)
        use_update_kernel = kernel_switch(use_update_kernel, self.device)
        self._use_update_kernel = use_update_kernel
        self.max_candidates = int(max_candidates_per_group)
        self.use_kernel = kernel_switch(use_kernel, self.device)
        self.mode = mode
        self.total = 0
        self._pools: List[SpaceSaving] = [
            SpaceSaving(self.max_candidates, len(g))
            for g in base_spec.partition
        ]
        if use_update_kernel and mode == "linear":
            # the state moves into the kernel wrapper's concatenated padded
            # table; ``state`` stays visible as a cached view of it
            self._kh = KernelHierarchy.from_state(self.hspec, self._state)
            self._state = None

    @property
    def state(self) -> hh.HierarchyState:
        """The hierarchy state (level views of the fused table on the
        update-kernel path)."""
        if self._kh is not None:
            return self._kh.state()
        return self._state

    @state.setter
    def state(self, value) -> None:
        if getattr(self, "_kh", None) is not None:
            self._kh.load_state(value)
        else:
            self._state = value

    @property
    def device(self) -> torch.device:
        return self.state.states[-1].params.q.device

    def _ingest_active(self, items: np.ndarray, freqs: np.ndarray) -> None:
        """Fold one normalized block into the serving tables."""
        if self.mode == "conservative":
            sk.check_conservative_freqs(freqs, self.state.states[0].table.dtype)
        if self._kh is not None:
            # reject kernel-refused weights BEFORE touching pools or
            # totals, so a failed ingest leaves the endpoint unchanged
            check_linear_kernel_freqs(freqs, self._kh.table.dtype)
        self.total += int(freqs.sum())
        for j, g in enumerate(self.hspec.base.partition):
            self._pools[j].offer(items[:, list(g)], freqs)
        if self._kh is not None:
            self._kh.update(items, freqs)
            return
        # pad like the reference (zero-frequency rows are no-ops and stay
        # out of the pools, which were offered the unpadded block above)
        items, freqs, _ = pad_block_pow2(items, freqs, 1)
        fold = (hh.update_conservative_jit if self.mode == "conservative"
                else hh.update_jit)
        self.state = fold(self.hspec, self.state, items, freqs)

    def ingest(self, items: np.ndarray,
               freqs: Optional[np.ndarray] = None) -> None:
        items = np.asarray(items, dtype=np.uint32)
        if items.shape[0] == 0:
            return
        if freqs is None:
            freqs = np.ones(items.shape[0], dtype=np.int64)
        freqs = np.asarray(freqs)
        self._ingest_active(items, freqs)
        self._migration_tick(items, freqs)

    # -- two-phase ingest (the serve engine's pipeline) ----------------------

    def stage_block(self, items: np.ndarray,
                    freqs: Optional[np.ndarray] = None) -> Optional["StagedBlock"]:
        """Pipeline stage A: normalize + pad the block, compute the cascade.

        Nothing is folded and no endpoint state changes until
        :meth:`fold_staged`.  Plain linear path only: the fused update
        kernel folds inside one launch (nothing to split) and conservative
        updates read the tables they write (no table-free stage exists).
        """
        if self.mode != "linear" or self._kh is not None:
            raise ValueError(
                "stage_block requires the plain linear update path: "
                "conservative updates read the tables during the fold and "
                "the fused update kernel is already a single launch -- use "
                "ingest() on those endpoints")
        items = np.asarray(items, dtype=np.uint32)
        if items.shape[0] == 0:
            return None
        if freqs is None:
            freqs = np.ones(items.shape[0], dtype=np.int64)
        freqs = np.asarray(freqs)
        p_items, p_freqs, _ = pad_block_pow2(items, freqs, 1)
        idxs = hh.stage_indices(self.hspec, self.state, p_items)
        return StagedBlock(idxs=idxs, freqs=sk.as_freqs(p_freqs, self.device),
                           raw_items=items, raw_freqs=freqs,
                           mass=int(freqs.sum()))

    def fold_staged(self, staged: Optional["StagedBlock"]) -> None:
        """Pipeline stage B: fold a staged block's pre-computed indices.

        ``fold_staged(stage_block(items, freqs))`` is bit-identical to
        ``ingest(items, freqs)``: same totals, pool offers and tables.
        """
        if staged is None:
            return
        self.total += staged.mass
        for j, g in enumerate(self.hspec.base.partition):
            self._pools[j].offer(staged.raw_items[:, list(g)],
                                 staged.raw_freqs)
        self._state = hh.fold_indices(self._state, staged.idxs, staged.freqs)
        self._migration_tick(staged.raw_items, staged.raw_freqs)

    def candidates(self) -> List[np.ndarray]:
        """Per-group candidate value arrays from the space-saving pools."""
        return [p.values() for p in self._pools]

    # -- durable state ---------------------------------------------------------

    def _config_fingerprint(self) -> np.ndarray:
        # numpy's dtype name, as the reference prints its jnp dtype
        dtype = numpy_dtype_name(self.state.states[0].table.dtype)
        desc = (f"endpoint|{self.hspec.base!r}|mode={self.mode}"
                f"|dtype={dtype}|cap={self.max_candidates}")
        return np.frombuffer(desc.encode(), dtype=np.uint8).copy()

    def state_dict(self) -> dict:
        """Full endpoint state as a flat ``{key: ndarray}`` mapping, with the
        reference's keys, dtypes and fingerprint: it loads into the
        reference's ``SketchTopKEndpoint.load_state_dict`` bit for bit.

        Refused mid-migration: the successor's tables are transient
        double-write state; call ``abort_migration()`` (or wait for
        cutover) first."""
        if self._migration is not None:
            raise ValueError(
                "cannot checkpoint an endpoint mid-migration: the warmup "
                "successor's state is transient; call abort_migration() to "
                "roll back to the active surface (or wait for cutover), "
                "then snapshot")
        state = self.state
        fine = state.states[-1].params
        out = {
            "meta.total": np.asarray(self.total, dtype=np.int64),
            "meta.fingerprint": self._config_fingerprint(),
            "params.q": fine.q.cpu().numpy().astype(np.uint32),
            "params.r": fine.r.cpu().numpy().astype(np.uint32),
        }
        for i, st in enumerate(state.states):
            out[f"level{i}.table"] = st.table.cpu().numpy()
        for j, p in enumerate(self._pools):
            for k, v in p.state_dict().items():
                out[f"pool{j}.{k}"] = v
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Restore a state saved by :meth:`state_dict` or by the reference's
        ``SketchTopKEndpoint.state_dict``; bit-exact round trip."""
        fp = self._config_fingerprint()
        got = np.asarray(sd["meta.fingerprint"], dtype=np.uint8)
        if not np.array_equal(fp, got):
            raise ValueError(
                "endpoint state_dict fingerprint mismatch: saved "
                f"{bytes(got).decode(errors='replace')!r}, this endpoint is "
                f"{bytes(fp).decode(errors='replace')!r}")
        device = self.device
        base = sk.resolve_params(self.hspec.levels[-1],
                                 (sd["params.q"], sd["params.r"]), device)
        states = []
        for i in range(self.hspec.n_levels):
            states.append(sk.SketchState(
                params=hh.level_params(self.hspec, base, i),
                table=torch.from_numpy(np.array(sd[f"level{i}.table"])).to(device)))
        self.state = hh.HierarchyState(states=tuple(states))
        self.total = int(sd["meta.total"])
        for j, p in enumerate(self._pools):
            p.load_state(sd[f"pool{j}.rows"], sd[f"pool{j}.counts"],
                         sd[f"pool{j}.errs"])

    # -- hot spec migration hooks (serving/migration.MigratingSurface) -------

    def _build_successor(self, new_spec, params) -> "SketchTopKEndpoint":
        return SketchTopKEndpoint(
            new_spec, params,
            max_candidates_per_group=self.max_candidates,
            use_kernel=self.use_kernel,
            use_update_kernel=self._use_update_kernel,
            dtype=self.state.states[0].table.dtype, mode="linear",
            device=self.device)

    def _adopt(self, inc: "SketchTopKEndpoint") -> None:
        """Adopt the successor's state wholesale; free the old tables.

        After this, the endpoint is bit-identical to a fresh endpoint built
        on the new spec (same params) and fed exactly the blocks since
        ``begin_migration`` -- the successor IS that endpoint.  On the
        update-kernel path its ``KernelHierarchy`` is taken over.  ``total``
        restarts at the post-warmup-start mass."""
        self.hspec = inc.hspec
        self._kh = inc._kh
        self._state = inc._state
        self._pools = inc._pools
        self.total = inc.total

    # -- queries ---------------------------------------------------------------

    def heavy_hitters(self, threshold: int,
                      candidates: Optional[List[np.ndarray]] = None,
                      ) -> Tuple[np.ndarray, np.ndarray]:
        if candidates is None:
            candidates = self.candidates()
        return hh.find_heavy_hitters(
            self.hspec, self.state, threshold, candidates,
            use_kernel=self.use_kernel)

    def topk(self, k: int,
             min_threshold: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k by estimate: geometric threshold descent until k found
        (:func:`repro_torch.serving.sharded_topk.threshold_descent_topk`)."""
        return threshold_descent_topk(
            self.heavy_hitters, self.candidates(), k, total=self.total,
            n_modules=self.hspec.base.schema.modularity,
            min_threshold=min_threshold)

    def to_sharded(self, *args, **kwargs):
        """Promotion to a sharded service: not ported yet.  A conservative
        endpoint refuses first, as the reference does: its tables must
        never enter the psum sync path."""
        require_not_migrating(self._migration, "SketchTopKEndpoint.to_sharded")
        if self.mode != "linear":
            raise ValueError(
                "to_sharded is only defined for linear endpoints: "
                "conservative tables cannot be psum-merged, so a "
                "conservative endpoint must stay single-shard")
        raise NotImplementedError(
            "SketchTopKEndpoint.to_sharded: sharded serving is not ported "
            "yet (ROADMAP item 12)")

    def merge_from(self, other: "SketchTopKEndpoint") -> None:
        """Fold another endpoint's sketch + pools in (cross-shard merge).

        Only defined for linear endpoints: a cell-wise sum of two
        conservatively built hierarchies is not the hierarchy of the union
        stream, so conservative endpoints are refused (both directions).
        Shards must share the base spec and hash parameters: cell-wise
        sums of tables hashed with different params are garbage, so
        mismatches are rejected.
        """
        require_not_migrating(self._migration,
                              "SketchTopKEndpoint.merge_from")
        require_not_migrating(other._migration,
                              "SketchTopKEndpoint.merge_from (source side)")
        if self.mode != "linear" or other.mode != "linear":
            raise ValueError(
                "merge_from is only defined for linear endpoints: "
                "conservative tables cannot be merged cell-wise")
        if self.hspec.base != other.hspec.base:
            raise ValueError(
                "merge_from requires identical base specs on both endpoints")
        for sa, sb in zip(self.state.states, other.state.states):
            if not (torch.equal(sa.params.q, sb.params.q.to(sa.params.q.device))
                    and torch.equal(sa.params.r, sb.params.r.to(sa.params.r.device))):
                raise ValueError(
                    "merge_from requires identical hash params on both "
                    "endpoints (build them from the same spec and key)")
        self.state = hh.merge(self.state, other.state)
        self.total += other.total
        for mine, theirs in zip(self._pools, other._pools):
            mine.merge_from(theirs)


@dataclasses.dataclass
class StagedBlock:
    """One staged block: computed cascade + deferred fold."""
    idxs: Tuple[torch.Tensor, ...]  # per-level cell indices
    freqs: torch.Tensor             # padded frequencies matching idxs
    raw_items: np.ndarray           # unpadded block (pools)
    raw_freqs: np.ndarray
    mass: int                       # int(raw_freqs.sum())


# --------------------------------------------------------------------------
# async serve engine: staged ingest, snapshots, batched descent
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SketchQuery:
    """One serving request for the engine's submit/flush lifecycle.

    ``kind`` is ``"topk"`` (uses ``k``/``min_threshold``) or
    ``"heavy_hitters"`` (uses ``threshold``).  ``items``/``est`` carry the
    answer after the flush that served it.
    """
    rid: int
    kind: str                                  # 'topk' | 'heavy_hitters'
    k: int = 0
    threshold: int = 0
    min_threshold: Optional[int] = None
    items: Optional[np.ndarray] = None
    est: Optional[np.ndarray] = None
    done: bool = False


@dataclasses.dataclass(frozen=True)
class SketchSnapshot:
    """An immutable query view of a backend: copied tables + frozen pools.

    ``total`` is the backend's stream mass when taken (seeds the top-k
    threshold descent); ``mass`` is the ENGINE's cumulative ingested mass
    at the same instant -- the staleness watermark.
    """
    hspec: Any
    state: Any                                 # HierarchyState, tables copied
    candidates: List[np.ndarray]
    total: int
    mass: int


class SketchServeEngine:
    """Async serving engine over a :class:`SketchTopKEndpoint` or a
    :class:`~repro_torch.serving.windowed_topk.WindowedTopKService` --
    anything with ``ingest``/``state``/``candidates``/``total``/``hspec``.

    **Staged ingest.**  On a plain linear endpoint (no fused update
    kernel), each block is only *staged* -- its hash cascade computed --
    and folded at the next ingest or sync.  Every other endpoint ingests
    synchronously.  Either way the tables after a drain are bit-identical
    to direct endpoint ingest.

    **Snapshot queries with a staleness bound.**  Queries run against a
    :class:`SketchSnapshot` whose tables were COPIED at the last refresh.
    ``max_staleness`` bounds the stream mass ingested since the snapshot:
    0 refreshes on every post-ingest query (bit-identical to the endpoint);
    None refreshes only on an explicit :meth:`sync`.

    **Batched multi-request descent.**  :meth:`submit` queues
    :class:`SketchQuery` requests; :meth:`flush` serves all of them against
    one snapshot with one launch per level per round
    (core.hierarchy.batched_find_heavy_hitters); each answer is
    bit-identical to its own serial call.

    **Maintenance.**  :meth:`advance` is a windowed backend's epoch clock;
    it changes the window without moving stream mass, so it invalidates the
    snapshot.  An optional ``tuner`` (serving/autotune.AutoTuner) steps on
    every :meth:`sync`, so retune decisions and migrations happen at
    snapshot boundaries; migration double-writes ride inside the backend's
    own ingest.  Sharded backends arrive with ROADMAP item 12.

    Thread safety: one re-entrant lock around every entry point.
    """

    def __init__(self, backend, *, max_staleness: Optional[int] = 0,
                 tuner=None):
        self.backend = backend
        self.max_staleness = max_staleness
        self.tuner = tuner
        self._lock = threading.RLock()
        self._staged: Optional[StagedBlock] = None
        self._mass = 0                       # engine staleness watermark
        self._queue: List[SketchQuery] = []
        self._next_rid = 0
        self._snap: Optional[SketchSnapshot] = None
        self._snap = self._take_snapshot()

    # -- ingest side ---------------------------------------------------------

    def _can_pipeline(self) -> bool:
        b = self.backend
        return (isinstance(b, SketchTopKEndpoint) and b.mode == "linear"
                and b._kh is None and not b.migrating)

    def ingest(self, items: np.ndarray,
               freqs: Optional[np.ndarray] = None) -> None:
        """Ingest one weighted block (staged where the backend allows)."""
        with self._lock:
            items = np.asarray(items, dtype=np.uint32)
            if items.shape[0] == 0:
                return
            if freqs is None:
                freqs = np.ones(items.shape[0], dtype=np.int64)
            freqs = np.asarray(freqs)
            self._fold_pending()             # fold k before staging k+1
            if self._can_pipeline():
                self._staged = self.backend.stage_block(items, freqs)
            else:
                self.backend.ingest(items, freqs)
            self._mass += int(freqs.sum())

    def _fold_pending(self) -> None:
        if self._staged is not None:
            staged, self._staged = self._staged, None
            self.backend.fold_staged(staged)

    def drain(self) -> None:
        """Fold any staged block; the backend then holds every ingested item."""
        with self._lock:
            self._fold_pending()

    def advance(self) -> None:
        """Epoch clock passthrough for windowed backends.

        Advancing changes the window tables WITHOUT moving stream mass, so
        the staleness bound alone cannot see it: the snapshot is
        invalidated and the next query refreshes."""
        with self._lock:
            self._fold_pending()
            self.backend.advance()
            self._snap = None

    # -- snapshot / staleness -------------------------------------------------

    def _take_snapshot(self) -> SketchSnapshot:
        b = self.backend
        st = b.state
        if callable(st):                     # the windowed service's method
            st = st()
        state = hh.HierarchyState(states=tuple(
            sk.SketchState(params=s.params, table=s.table.clone())
            for s in st.states))
        return SketchSnapshot(hspec=b.hspec, state=state,
                              candidates=b.candidates(),
                              total=int(b.total), mass=self._mass)

    @property
    def staleness(self) -> int:
        """Stream mass ingested since the serving snapshot was taken."""
        with self._lock:
            return self._mass - self._snap.mass if self._snap else self._mass

    @property
    def ingested_mass(self) -> int:
        """The engine's cumulative-mass watermark (staleness clock)."""
        with self._lock:
            return self._mass

    def restore_watermark(self, mass: int) -> None:
        """Reset the staleness clock after a backend restore and retake the
        snapshot, so queries see the restored tables immediately."""
        with self._lock:
            self._staged = None             # staged indices from the old life
            self._mass = int(mass)
            self._snap = self._take_snapshot()

    def sync(self) -> SketchSnapshot:
        """Drain the pipeline, refresh the snapshot and tick the auto-tuner.
        The one barrier in the engine."""
        with self._lock:
            self._fold_pending()
            self._snap = self._take_snapshot()
            if self.tuner is not None:
                # retune on snapshot boundaries only: a migration opened here
                # double-writes inside the backend's own ingest, and queries
                # keep serving the old tables, which this snapshot holds
                self.tuner.step()
            return self._snap

    def _fresh_snapshot(self) -> SketchSnapshot:
        if self._snap is None or (
                self.max_staleness is not None
                and self._mass - self._snap.mass > self.max_staleness):
            self.sync()
        return self._snap

    # -- synchronous query surface (one request) ------------------------------

    def heavy_hitters(self, threshold: int) -> Tuple[np.ndarray, np.ndarray]:
        """Every key estimated >= threshold, within the staleness bound."""
        with self._lock:
            snap = self._fresh_snapshot()
            return hh.find_heavy_hitters(
                snap.hspec, snap.state, threshold, snap.candidates,
                use_kernel=self.backend.use_kernel)

    def topk(self, k: int, min_threshold: Optional[int] = None,
             ) -> Tuple[np.ndarray, np.ndarray]:
        """The k keys with the largest estimates, within the staleness bound."""
        with self._lock:
            snap = self._fresh_snapshot()

            def hh_fn(thr, candidates):
                return hh.find_heavy_hitters(
                    snap.hspec, snap.state, thr, candidates,
                    use_kernel=self.backend.use_kernel)

            return threshold_descent_topk(
                hh_fn, snap.candidates, k, total=snap.total,
                n_modules=snap.hspec.base.schema.modularity,
                min_threshold=min_threshold)

    # -- batched query surface (submit/flush protocol) -------------------------

    def submit_topk(self, k: int,
                    min_threshold: Optional[int] = None) -> SketchQuery:
        """Queue a top-k request for the next :meth:`flush`."""
        return self.submit(SketchQuery(rid=-1, kind="topk", k=int(k),
                                       min_threshold=min_threshold))

    def submit_heavy_hitters(self, threshold: int) -> SketchQuery:
        """Queue a heavy-hitters request for the next :meth:`flush`."""
        return self.submit(SketchQuery(rid=-1, kind="heavy_hitters",
                                       threshold=int(threshold)))

    def submit(self, request: SketchQuery) -> SketchQuery:
        with self._lock:
            if request.kind not in ("topk", "heavy_hitters"):
                raise ValueError(
                    f"kind must be 'topk' or 'heavy_hitters', got "
                    f"{request.kind!r}")
            request.rid = self._next_rid
            self._next_rid += 1
            self._queue.append(request)
            return request

    def flush(self) -> List[SketchQuery]:
        """Serve every queued request against ONE snapshot, batched.
        Returns the requests in submission order."""
        with self._lock:
            reqs, self._queue = self._queue, []
            if not reqs:
                return []
            snap = self._fresh_snapshot()
            self._serve_batched(snap, reqs)
            return reqs

    def _serve_batched(self, snap: SketchSnapshot,
                       reqs: List[SketchQuery]) -> None:
        """The packed threshold descent: one launch per level per round.

        Replicates :func:`threshold_descent_topk` per request -- same
        starting threshold ``max(total, 1)``, same ``max(1, total >> 17)``
        floor, same geometric /4 schedule, same stop condition -- but
        evaluates every still-descending request's round together.
        """
        total = snap.total
        thr, floor = {}, {}
        for r in reqs:
            if r.kind == "heavy_hitters":
                thr[r.rid] = int(r.threshold)
                floor[r.rid] = None          # single evaluation, no descent
            else:
                m = (r.min_threshold if r.min_threshold is not None
                     else max(1, total >> 17))
                floor[r.rid] = int(m)
                thr[r.rid] = max(total, 1)

        # a floor above the starting threshold never evaluates at all in
        # the serial descent (`while thr >= min_threshold` fails upfront)
        n_mods = snap.hspec.base.schema.modularity
        pending = []
        for r in reqs:
            if r.kind == "topk" and thr[r.rid] < floor[r.rid]:
                r.items = np.zeros((0, n_mods), np.uint32)
                r.est = np.zeros((0,), np.int64)
                r.done = True
            else:
                pending.append(r)
        while pending:
            results = hh.batched_find_heavy_hitters(
                snap.hspec, snap.state, [thr[r.rid] for r in pending],
                snap.candidates, use_kernel=self.backend.use_kernel)
            nxt = []
            for r, (items, est) in zip(pending, results):
                if r.kind == "heavy_hitters":
                    r.items, r.est, r.done = items, est, True
                elif len(est) >= r.k or thr[r.rid] == floor[r.rid]:
                    r.items, r.est, r.done = items[: r.k], est[: r.k], True
                else:
                    thr[r.rid] = max(floor[r.rid], thr[r.rid] // 4)
                    nxt.append(r)
            pending = nxt
