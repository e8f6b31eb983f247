"""Hot spec migration: the double-write window between two sketch specs.

Port of ``repro/serving/migration.py``.  Where the reference takes a jax
key for the successor's hash draw, the port takes ``params``: a
``torch.Generator`` or the finest level's ``(q, r)`` arrays, as every
port constructor does.

A serving endpoint cannot atomically swap to a re-tuned SketchSpec: the
new spec's tables start empty, so cutting over immediately would answer
queries from a sketch that has seen nothing.  The migration protocol the
serving endpoint (serving/sketch_engine.SketchTopKEndpoint) implements by
mixing in :class:`MigratingSurface` on top of this holder (the sharded
service, not ported yet, is its other user in the reference):

  1. ``begin_migration(new_spec, params, warmup=W)`` builds a FRESH successor
     service on the new spec (empty tables, empty pools, total = 0);
  2. every subsequent ingest **double-writes**: the block folds into the
     active (old-spec) tables as always AND into the successor;
  3. queries keep serving from the active tables -- the successor is
     invisible until it has absorbed ``W`` stream mass;
  4. once the successor's total reaches ``W``, the service **cuts over**:
     the successor's state (tables, pools, hash params, total) becomes the
     service's state wholesale and the old tables are freed (last
     references dropped).

Post-cutover the service is *bit-identical* to a fresh service built on
the new spec from the same params and fed exactly the post-warmup-start
stream -- the successor IS such a service, fed block-for-block.  That is
the migration-correctness contract tests/test_torch_migration.py holds.

Linear mode only.  A conservative (Estan-Varghese) endpoint could in
principle double-write, but its post-cutover total/estimate semantics
could not be validated against the linear merge/fold contracts the rest
of the stack leans on, and every consumer of migration (auto-tuning, the
elastic re-meshing) runs on the linear psum paths -- so
``begin_migration`` refuses conservative mode via
``core.distributed.require_linear``, same as every sharded surface.

Mutating the spec-carrying state mid-window is also refused:
``merge_from`` / ``to_sharded`` during warmup would have to be replayed
into the successor to keep the bit-identity contract, which is exactly
the kind of silent divergence this layer exists to prevent
(:func:`require_not_migrating`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.distributed import require_linear


class MigratingSurface:
    """Mixin: the migration scaffolding shared by every serving surface.

    The migration plumbing (the ``migrating`` / ``migration_progress``
    properties, the one-at-a-time guard, the offer -> ready -> cutover
    ingest tail), written once.  A surface contributes exactly two hooks:

      ``_build_successor(new_spec, params)``  a fresh, EMPTY sibling service
          on the new spec, mirroring this surface's own configuration
          (pool capacity, dtype, kernel settings, device);
      ``_adopt(successor)``  copy the successor's state fields over
          wholesale at cutover (the per-surface field list).

    and calls ``_migration_tick(raw_items, raw_freqs)`` at the end of its
    ingest with the UNPADDED block -- the successor pads/splits its own
    blocks exactly like a fresh service would, which is what keeps
    cutover bit-identical to a fresh build on the new spec.
    """

    _migration: Optional["SpecMigration"] = None
    mode: str = "linear"

    @property
    def migrating(self) -> bool:
        return self._migration is not None

    @property
    def migration_progress(self) -> float:
        """Warmup progress in [0, 1]; 1.0 when no migration is in flight."""
        return 1.0 if self._migration is None else self._migration.progress

    def begin_migration(self, new_spec, params, *, warmup: int) -> None:
        """Open a double-write window onto a fresh service on ``new_spec``.

        From the next ingest on, every block folds into BOTH the active
        tables and a successor built by ``_build_successor`` (same pool
        capacity, table dtype, kernel settings and device as this surface)
        from ``params``: a ``torch.Generator`` or the new spec's finest
        level's ``(q, r)`` arrays.
        Queries keep answering from the active tables until the successor
        has absorbed ``warmup`` stream mass (sum of ingested
        frequencies); the ingest that crosses the threshold cuts over:
        the successor's state becomes this surface's state wholesale and
        the old tables are freed.

        Linear mode only -- conservative tables are excluded from every
        migration consumer (auto-tuning, re-meshing) and refused here via
        the same guard as the sharded surfaces.  One migration at a time.
        """
        require_linear(self.mode, f"{type(self).__name__}.begin_migration")
        if self._migration is not None:
            raise ValueError(
                "a spec migration is already in flight "
                f"({self._migration.progress:.0%} of warmup); one at a time")
        self._migration = SpecMigration(
            self._build_successor(new_spec, params), warmup)

    def abort_migration(self) -> None:
        """Roll back an in-flight migration to the active surface.

        Safe at any warmup point: double-write only ever writes the
        *successor*, the active tables/pools/totals are untouched by the
        migration machinery, so dropping the successor leaves no residue
        -- queries before and after the abort are answered from the same
        active state.  No-op when no migration is in flight (aborting
        twice, or after cutover already happened, is not an error)."""
        self._migration = None

    def _migration_tick(self, raw_items: np.ndarray,
                        raw_freqs: Optional[np.ndarray]) -> None:
        """Double-write one ingested block; cut over when warmup is done."""
        if self._migration is None:
            return
        self._migration.offer(raw_items, raw_freqs)
        if self._migration.ready:
            inc = self._migration.incoming
            self._migration = None
            self._adopt(inc)

    # -- per-surface hooks --------------------------------------------------

    def _build_successor(self, new_spec, params):
        raise NotImplementedError

    def _adopt(self, successor) -> None:
        raise NotImplementedError


class SpecMigration:
    """State holder for one in-flight migration: the successor + its window.

    ``incoming`` is the freshly built successor service (any object with
    ``ingest(items, freqs)`` and an integer ``total``); ``warmup`` is the
    stream mass (sum of frequencies, the same unit as ``total``) the
    successor must absorb before cutover.
    """

    def __init__(self, incoming, warmup: int):
        warmup = int(warmup)
        if warmup < 1:
            raise ValueError("warmup must be >= 1 stream mass units")
        if int(incoming.total) != 0:
            raise ValueError(
                "the migration successor must start empty (total == 0): "
                "bit-identity with a fresh service on the new spec is the "
                "whole contract")
        self.incoming = incoming
        self.warmup = warmup

    def offer(self, items: np.ndarray, freqs: Optional[np.ndarray]) -> None:
        """Double-write one ingested block into the successor."""
        self.incoming.ingest(items, freqs)

    @property
    def ready(self) -> bool:
        """True once the successor has absorbed the warmup mass."""
        return int(self.incoming.total) >= self.warmup

    @property
    def progress(self) -> float:
        """Warmup progress in [0, 1]."""
        return min(1.0, int(self.incoming.total) / self.warmup)


def require_not_migrating(migration: Optional[SpecMigration],
                          entry: str) -> None:
    """Refuse state-mutating entry points while a migration is in flight.

    Folding foreign state (``merge_from``) or re-homing the tables
    (``to_sharded``) mid-warmup would change the active state without the
    successor seeing the same change, silently breaking the post-cutover
    bit-identity contract -- refused loudly instead, finish (or never
    start) the warmup first.
    """
    if migration is not None:
        raise ValueError(
            f"{entry} is not allowed while a spec migration is in its "
            "warmup window: the successor would not see the same state "
            "change and cutover would diverge from a fresh-build of the "
            "new spec; wait for cutover (or don't start the migration)")
