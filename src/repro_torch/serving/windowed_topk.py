"""Windowed heavy-hitter / top-k serving over the epoch ring.

Port of ``repro/serving/windowed_topk.py``.  :class:`WindowedTopKService`
answers "top-k in the last W epochs" (or with exponential time decay) by
wrapping core/window.py's ring of per-epoch hierarchies behind the same
ingest/query surface as the since-boot endpoint
(serving/sketch_engine.SketchTopKEndpoint):

  ingest    fold a weighted key block into the CURRENT epoch's tables and
            into that epoch's per-group space-saving candidate pools;
  advance   close the epoch: the oldest ring slot expires (dropped, or
            folded into the landmark accumulator) together with its
            candidate pools, and -- on the incremental tumbling path --
            its tables are SUBTRACTED from the running window sum, exact by
            linearity and bit-identical to re-summing the live slots;
  query     heavy_hitters / topk run the descent against the merged window
            state with candidates folded from the LIVE epochs' pools only,
            so expired keys cannot re-enter the candidate sets.

Incremental window sum (``incremental=True``, tumbling/landmark): the
service keeps a running stack of all levels, folds each ingested block into
it beside the head epoch, and subtracts expiring stacks on advance.  Decay
mode always merges lazily (Horner re-weights every epoch on every advance).

``use_update_kernel=True`` folds each block with one launch of the fused
hierarchy fold a stack (K3 on int32 tables, K3f on the decayed window's
float32 ones); ``use_kernel=True`` scores the descent's grids with K4 or
K4f.  Both take their plain versions on CPU tensors, and both left at
``None`` follow the tables' device, as on the endpoint
(:func:`repro_torch.device.kernel_switch`).  As on the endpoint,
the plain path pads each block to a power of two like the reference and
the kernel path does not (zero-frequency rows are no-ops); the pools are
offered the unpadded block either way.  ``state_dict`` has the reference's
keys, so a reference service's state loads here and answers the same.

Everything here is linear-mode only: the service refuses
``mode="conservative"`` with ``core.distributed.require_linear``.
``merge_from`` composes aligned sibling services cell-wise.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.core import window as win
from repro_torch.core.distributed import pad_block_pow2, require_linear
from repro_torch.core.summary import SpaceSaving
from repro_torch.device import DeviceLike, kernel_switch, numpy_dtype_name
from repro_torch.kernels.ops import check_linear_kernel_freqs
from repro_torch.serving.sharded_topk import threshold_descent_topk


class WindowedTopKService:
    """Sliding-window / decayed heavy-hitter serving on one device.

    ``n_epochs`` fixes the ring size W; ``window_mode`` picks
    tumbling/landmark/decay; ``advance()`` is the epoch clock.  ``params``
    replaces the reference's jax key: a ``torch.Generator`` or the finest
    level's ``(q, r)`` arrays.  All epochs (and any merge-compatible sibling
    service) share them.  ``device=None`` means ``cuda``.
    """

    def __init__(self, base_spec: sk.SketchSpec, params, *,
                 n_epochs: int, window_mode: str = "tumbling",
                 decay: float = 1.0,
                 max_candidates_per_group: int = 1 << 16,
                 use_kernel: Optional[bool] = None,
                 use_update_kernel: Optional[bool] = None,
                 dtype=None, incremental: bool = True, mode: str = "linear",
                 device: DeviceLike = None):
        require_linear(mode, "WindowedTopKService")
        self.mode = mode
        self.wspec = win.WindowSpec(base=base_spec, n_epochs=int(n_epochs),
                                    mode=window_mode, decay=float(decay))
        self.hspec = self.wspec.hspec
        self.wstate = win.init_window(self.wspec, params, dtype=dtype, device=device)
        self.max_candidates = int(max_candidates_per_group)
        self.use_kernel = kernel_switch(use_kernel, self.device)
        self.use_update_kernel = kernel_switch(use_update_kernel, self.device)
        # decay re-weights every live epoch on advance; only the equal-
        # weight modes admit the add/subtract running sum
        self.incremental = bool(incremental) and window_mode != "decay"
        self._window_sum: Optional[torch.Tensor] = (
            torch.zeros_like(self.wstate.ring[0]) if self.incremental else None)
        # ring of per-epoch per-group candidate pools, expired with their
        # epoch's tables so dead keys cannot linger in the candidate sets
        self._pools: List[List[SpaceSaving]] = [
            self._fresh_pools() for _ in range(self.wspec.n_epochs)]
        self._epoch_totals = [0] * self.wspec.n_epochs
        self._retired_total = 0

    def _fresh_pools(self) -> List[SpaceSaving]:
        return [SpaceSaving(self.max_candidates, len(g))
                for g in self.wspec.base.partition]

    @property
    def device(self) -> torch.device:
        return self.wstate.ring[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.wstate.ring[0].dtype

    # -- ingest / epoch clock ----------------------------------------------

    def ingest(self, items: np.ndarray,
               freqs: Optional[np.ndarray] = None) -> None:
        """Fold a weighted key block into the current epoch."""
        items = np.asarray(items, dtype=np.uint32)
        if items.shape[0] == 0:
            return
        if freqs is None:
            freqs = np.ones(items.shape[0], dtype=np.int64)
        freqs = np.asarray(freqs)
        if self.use_update_kernel:
            # refuse what the kernels refuse before touching pools or totals
            check_linear_kernel_freqs(freqs, self.dtype)
        self._epoch_totals[self.wstate.head] += int(freqs.sum())
        pools = self._pools[self.wstate.head]
        for j, g in enumerate(self.wspec.base.partition):
            pools[j].offer(items[:, list(g)], freqs)
        if not self.use_update_kernel:
            items, freqs, _ = pad_block_pow2(items, freqs, 1)
        # one hash input for both folds: the head epoch and the running
        # sum fold the identical cascade, so they stay bit-equal
        chunks = win.block_chunks(self.wspec, self.wstate, items)
        stacks = [self.wstate.ring[self.wstate.head]]
        if self._window_sum is not None:
            stacks.append(self._window_sum)
        for stack in stacks:
            win.fold_chunks(self.wspec, self.wstate, stack, chunks, freqs,
                            use_update_kernel=self.use_update_kernel)

    def advance(self) -> None:
        """Close the current epoch and open a fresh one.

        Tumbling: the expiring slot's tables are subtracted from the running
        window sum (incremental path) or dropped from the lazy merge; its
        candidate pools and total expire with it.  Landmark: tables fold
        into the retired accumulator and the expiring pools into the fresh
        slot, so since-boot candidates stay reachable."""
        new_head = (self.wstate.head + 1) % self.wspec.n_epochs
        if self._window_sum is not None and self.wspec.mode == "tumbling":
            self._window_sum.sub_(self.wstate.ring[new_head])
        self.wstate = win.advance_window(self.wspec, self.wstate)
        if self.wspec.mode == "landmark":
            self._retired_total += self._epoch_totals[new_head]
            self._pools[new_head] = [SpaceSaving.fold([p]) for p in self._pools[new_head]]
        else:
            self._pools[new_head] = self._fresh_pools()
        self._epoch_totals[new_head] = 0

    # -- window views -------------------------------------------------------

    @property
    def epoch(self) -> int:
        return self.wstate.epoch

    @property
    def total(self) -> int:
        """Stream mass inside the current window (decay: Horner-weighted in
        Python floats, then truncated -- it only seeds the top-k descent)."""
        live = win.live_slots(self.wspec, self.wstate)
        if self.wspec.mode == "decay":
            acc = 0.0
            for s in live:
                acc = acc * self.wspec.decay + self._epoch_totals[s]
            return max(1, int(acc))
        return self._retired_total + sum(self._epoch_totals[s] for s in live)

    def state(self) -> hh.HierarchyState:
        """The merged window hierarchy the queries run against.

        On the incremental path, level views of the running sum (live until
        the next ingest or advance; tumbling subtracts expiring epochs and
        landmark never does, so it already holds everything since boot);
        otherwise a lazily merged buffer."""
        if self._window_sum is not None:
            return win.hier_state(self.wspec, self.wstate, self._window_sum)
        return win.merged_state(self.wspec, self.wstate)

    def candidates(self) -> List[np.ndarray]:
        """Per-group candidates folded from the LIVE epochs' pools, rows
        sorted lexicographically so the descent order never depends on pool
        iteration order."""
        live = win.live_slots(self.wspec, self.wstate)
        out = []
        for j in range(len(self.wspec.base.partition)):
            folded = SpaceSaving.fold([self._pools[s][j] for s in live])
            vals = folded.values()
            out.append(np.unique(vals, axis=0) if len(vals) else vals)
        return out

    # -- durable state ---------------------------------------------------------

    def _config_fingerprint(self) -> np.ndarray:
        desc = (f"windowed|{self.wspec!r}|dtype={numpy_dtype_name(self.dtype)}"
                f"|cap={self.max_candidates}|inc={self.incremental}")
        return np.frombuffer(desc.encode(), dtype=np.uint8).copy()

    def _levels_np(self, stack: torch.Tensor) -> List[np.ndarray]:
        return [t.cpu().numpy() for t in win.level_views(self.wspec, stack)]

    def state_dict(self) -> dict:
        """Full windowed state as a flat ``{key: ndarray}`` mapping with the
        reference's keys, dtypes and fingerprint: every ring slot's level
        tables, the retired accumulator, the shared hash params (finest
        level's), the epoch clock, per-slot totals and pools and, on the
        incremental path, the running window sum."""
        fine = self.wstate.level_params[-1]
        out = {
            "meta.fingerprint": self._config_fingerprint(),
            "meta.head": np.asarray(self.wstate.head, dtype=np.int64),
            "meta.epoch": np.asarray(self.wstate.epoch, dtype=np.int64),
            "meta.epoch_totals": np.asarray(self._epoch_totals, dtype=np.int64),
            "meta.retired_total": np.asarray(self._retired_total, dtype=np.int64),
            "params.q": fine.q.cpu().numpy().astype(np.uint32),
            "params.r": fine.r.cpu().numpy().astype(np.uint32),
        }
        for s, stack in enumerate(self.wstate.ring):
            for l, t in enumerate(self._levels_np(stack)):
                out[f"ring{s}.level{l}.table"] = t
        # only landmark mode holds the retired accumulator; the other modes
        # save the zeros the reference keeps there
        retired = (self._levels_np(self.wstate.retired)
                   if self.wstate.retired is not None else
                   [np.zeros((self.wspec.base.width, h), numpy_dtype_name(self.dtype))
                    for h in self.wspec.hplan.level_sizes])
        for l, t in enumerate(retired):
            out[f"retired.level{l}.table"] = t
        if self._window_sum is not None:
            for l, t in enumerate(self._levels_np(self._window_sum)):
                out[f"wsum.level{l}.table"] = t
        for s, pools in enumerate(self._pools):
            for j, p in enumerate(pools):
                for k, v in p.state_dict().items():
                    out[f"slot{s}.pool{j}.{k}"] = v
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Restore a state saved by :meth:`state_dict` or by the reference's
        ``WindowedTopKService.state_dict``; bit-exact round trip."""
        fp = self._config_fingerprint()
        got = np.asarray(sd["meta.fingerprint"], dtype=np.uint8)
        if not np.array_equal(fp, got):
            raise ValueError(
                "windowed state_dict fingerprint mismatch: saved "
                f"{bytes(got).decode(errors='replace')!r}, this service is "
                f"{bytes(fp).decode(errors='replace')!r}")
        device = self.device
        base = sk.resolve_params(self.hspec.levels[-1],
                                 (sd["params.q"], sd["params.r"]), device)
        n_levels = self.hspec.n_levels

        def stack(prefix: str) -> torch.Tensor:
            return win.pack_levels(self.wspec, [
                torch.from_numpy(np.array(sd[f"{prefix}.level{l}.table"])).to(device)
                for l in range(n_levels)])

        self.wstate = win.WindowState(
            level_params=tuple(hh.level_params(self.hspec, base, l)
                               for l in range(n_levels)),
            ring=tuple(stack(f"ring{s}") for s in range(self.wspec.n_epochs)),
            retired=stack("retired") if self.wspec.mode == "landmark" else None,
            head=int(sd["meta.head"]), epoch=int(sd["meta.epoch"]))
        self._window_sum = stack("wsum") if self.incremental else None
        self._epoch_totals = [int(x) for x in sd["meta.epoch_totals"]]
        self._retired_total = int(sd["meta.retired_total"])
        for s, pools in enumerate(self._pools):
            for j, p in enumerate(pools):
                p.load_state(sd[f"slot{s}.pool{j}.rows"],
                             sd[f"slot{s}.pool{j}.counts"],
                             sd[f"slot{s}.pool{j}.errs"])

    # -- queries ------------------------------------------------------------

    def heavy_hitters(self, threshold: int,
                      candidates: Optional[List[np.ndarray]] = None,
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Every key whose WINDOWED estimate is >= threshold."""
        if candidates is None:
            candidates = self.candidates()
        return hh.find_heavy_hitters(
            self.hspec, self.state(), threshold, candidates,
            use_kernel=self.use_kernel)

    def topk(self, k: int, min_threshold: Optional[int] = None,
             ) -> Tuple[np.ndarray, np.ndarray]:
        """The k keys with the largest windowed estimates."""
        return threshold_descent_topk(
            self.heavy_hitters, self.candidates(), k, total=self.total,
            n_modules=self.wspec.base.schema.modularity,
            min_threshold=min_threshold)

    # -- cross-shard composition (linearity, again) -------------------------

    def merge_from(self, other: "WindowedTopKService") -> None:
        """Fold a sibling service's window in, slot by slot: per-slot
        cell-wise adds, exact by linearity.  Requires identical specs,
        aligned epoch clocks and identical hash params; mismatches are
        refused."""
        if self.wspec != other.wspec:
            raise ValueError("merge_from requires identical WindowSpecs")
        if (self.wstate.head != other.wstate.head
                or self.wstate.epoch != other.wstate.epoch):
            raise ValueError(
                "merge_from requires aligned epoch clocks (same number of "
                "advance() calls on both services)")
        for pa, pb in zip(self.wstate.level_params, other.wstate.level_params):
            if not (torch.equal(pa.q, pb.q.to(pa.q.device))
                    and torch.equal(pa.r, pb.r.to(pa.r.device))):
                raise ValueError(
                    "merge_from requires identical hash params on both "
                    "services (build them from the same spec and key)")
        device = self.device
        for mine, theirs in zip(self.wstate.ring, other.wstate.ring):
            mine.add_(theirs.to(device))
        if self.wstate.retired is not None:
            self.wstate.retired.add_(other.wstate.retired.to(device))
        if self._window_sum is not None:
            # the lazy merge has the same coverage as a running sum: live
            # window for tumbling, since-boot (retired included) for landmark
            other_sum = (other._window_sum if other._window_sum is not None
                         else win.merged_stack(other.wspec, other.wstate))
            self._window_sum.add_(other_sum.to(device))
        for s in range(self.wspec.n_epochs):
            self._epoch_totals[s] += other._epoch_totals[s]
            for mine, theirs in zip(self._pools[s], other._pools[s]):
                mine.merge_from(theirs)
        self._retired_total += other._retired_total
