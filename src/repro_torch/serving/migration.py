"""Hot spec migration surface, PyTorch port -- the API without migrations.

Port of ``repro/serving/migration.py``'s :class:`MigratingSurface` and
:func:`require_not_migrating`.  In this slice no migration can start:
``begin_migration`` raises, so ``migrating`` is always False and the
ingest hook ``_migration_tick`` is a no-op.  The double-write window, the
successor build and the cutover arrive with live re-tuning (ROADMAP item
11).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.distributed import require_linear


class MigratingSurface:
    """Mixin: the migration surface shared by every serving surface."""

    _migration = None
    mode: str = "linear"

    @property
    def migrating(self) -> bool:
        return self._migration is not None

    @property
    def migration_progress(self) -> float:
        """Warmup progress in [0, 1]; 1.0 when no migration is in flight."""
        return 1.0

    def begin_migration(self, new_spec, params, *, warmup: int) -> None:
        """Not ported yet.  A conservative surface refuses first, with the
        reference's guard: its tables are excluded from every migration."""
        require_linear(self.mode, f"{type(self).__name__}.begin_migration")
        raise NotImplementedError(
            f"{type(self).__name__}.begin_migration: hot spec migration is "
            "not ported yet (ROADMAP item 11)")

    def abort_migration(self) -> None:
        """No-op: no migration can be in flight."""
        self._migration = None

    def _migration_tick(self, raw_items: np.ndarray,
                        raw_freqs: Optional[np.ndarray]) -> None:
        """Double-write hook of the ingest paths; nothing to do without a
        migration."""


def require_not_migrating(migration, entry: str) -> None:
    """Refuse state-mutating entry points while a migration is in flight."""
    if migration is not None:
        raise ValueError(
            f"{entry} is not allowed while a spec migration is in its "
            "warmup window: the successor would not see the same state "
            "change and cutover would diverge from a fresh-build of the "
            "new spec; wait for cutover (or don't start the migration)")
