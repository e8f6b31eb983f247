"""FCM sketch (Thomas et al., ICDE'09) and FMOD = MOD-Sketch on FCM (SVI-E).

Port of ``repro/core/fcm.py``.  FCM augments Count-Min with
frequency-aware hashing: a Misra-Gries counter identifies heavy hitters
online; high-frequency (HF) items are hashed into a *smaller* subset of
rows and low-frequency (LF) items into a larger one, the subset chosen per
item by two extra hashes computing an ``offset`` and a ``gap`` over the w
rows.  This separates HF mass from LF cells and cuts the error for the
long tail.

FMOD keeps FCM's row-subset mechanism but replaces the per-row *cell* index
with MOD-Sketch composite indexing -- the paper's generalizability demo
(Fig. 10): FMOD < FCM < Count-Min in observed error.

The Misra-Gries counter and the row subsets stay numpy on the host, as in
the reference.  The int64 table lives on the device; each block's cell
indices come from :func:`repro_torch.core.sketch.compute_indices` there,
and the fold is one ``index_put_`` with accumulation (the reference's
``np.add.at``; no kernel of the reference computes it).  The offset and gap
hashes are drawn from ``np.random.default_rng(seed)`` exactly as the
reference draws them, so one ``params`` draw gives both packages the same
table.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sketch as sk
from repro_torch.core.hashing import KeySchema, cw_hash_np, draw_hash_params_np
from repro_torch.device import DeviceLike


# --------------------------------------------------------------------------
# Batched Misra-Gries heavy-hitter counter (host side)
# --------------------------------------------------------------------------

class MisraGries:
    """Misra-Gries with batched (numpy) ingestion.

    Classic MG keeps k counters; on overflow it decrements all counters by the
    amount that empties at least one slot.  The batched variant ingests a
    chunk of (item, freq) pairs at once: it merges exact chunk counts into the
    counter set, then removes the smallest counters by subtracting the
    (size-k)-th largest value -- the same L1-decrement argument bounds the
    undercount by L/k, preserving the MG guarantee.
    """

    def __init__(self, k: int):
        self.k = int(k)
        self.counters: Dict[int, int] = {}
        self.total = 0

    def offer(self, keys: np.ndarray, freqs: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        freqs = np.asarray(freqs, dtype=np.int64)
        uniq, inv = np.unique(keys, return_inverse=True)
        sums = np.bincount(inv, weights=freqs.astype(np.float64)).astype(np.int64)
        self.total += int(freqs.sum())
        for key, s in zip(uniq.tolist(), sums.tolist()):
            self.counters[key] = self.counters.get(key, 0) + s
        if len(self.counters) > self.k:
            vals = np.fromiter(self.counters.values(), dtype=np.int64)
            # subtract the value that leaves at most k strictly-positive slots
            cut = np.partition(vals, len(vals) - self.k - 1)[len(vals) - self.k - 1]
            self.counters = {
                key: v - cut for key, v in self.counters.items() if v > cut
            }

    def heavy_hitters(self) -> Dict[int, int]:
        return dict(self.counters)

    def is_heavy(self, keys: np.ndarray) -> np.ndarray:
        hh = self.counters
        return np.fromiter((int(k) in hh for k in np.asarray(keys, dtype=np.uint64)),
                           dtype=bool, count=len(keys))


def pack_keys(schema: KeySchema, items: np.ndarray) -> np.ndarray:
    """Injective uint64 packing of a full key (for MG bookkeeping only)."""
    out = np.zeros(items.shape[0], dtype=np.uint64)
    for m, d in enumerate(schema.domains):
        out = out * np.uint64(d) + items[:, m].astype(np.uint64)
    return out


# --------------------------------------------------------------------------
# FCM / FMOD
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FCMSpec:
    base: sk.SketchSpec          # cell indexing: CM-style for FCM, MOD for FMOD
    d_hf: int                    # rows used by heavy hitters
    d_lf: int                    # rows used by the tail
    mg_k: int                    # Misra-Gries capacity

    def __post_init__(self):
        if not (1 <= self.d_hf <= self.base.width and 1 <= self.d_lf <= self.base.width):
            raise ValueError("row subset sizes must be within [1, w]")


class FCM:
    """Stateful FCM/FMOD wrapper (MG classification is inherently sequential).

    ``params`` replaces the reference's jax key: a ``torch.Generator`` or
    the ``(q, r)`` arrays of the base spec (e.g. the reference's
    ``np.asarray(fcm.params.q)`` / ``.r``).  ``seed`` draws the offset and
    gap hashes, as in the reference.  ``device=None`` means ``cuda``.
    """

    def __init__(self, spec: FCMSpec, params, seed: int = 0,
                 device: DeviceLike = None):
        self.spec = spec
        base = spec.base
        self.params = sk.resolve_params(base, params, device)
        self.table = torch.zeros((base.width, base.table_size), dtype=torch.int64,
                                 device=self.params.q.device)
        rng = np.random.default_rng(seed)
        c = base.schema.total_chunks
        self._off_q = draw_hash_params_np(rng, (c,))
        self._off_r = int(draw_hash_params_np(rng, (1,))[0])
        self._gap_q = draw_hash_params_np(rng, (c,))
        self._gap_r = int(draw_hash_params_np(rng, (1,))[0])
        self.mg = MisraGries(spec.mg_k)

    @property
    def device(self) -> torch.device:
        return self.table.device

    # -- row subset ---------------------------------------------------------
    def _rows(self, items: np.ndarray, heavy: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(rows uint32[B, max_d], valid bool[B, max_d]) for each item."""
        base = self.spec.base
        chunks = base.schema.module_chunks_np(items)
        w = base.width
        off = cw_hash_np(chunks, self._off_q, self._off_r) % np.uint32(w)
        gap = cw_hash_np(chunks, self._gap_q, self._gap_r) % np.uint32(max(1, w - 1)) + np.uint32(1)
        d_item = np.where(heavy, self.spec.d_hf, self.spec.d_lf)
        max_d = max(self.spec.d_hf, self.spec.d_lf)
        j = np.arange(max_d, dtype=np.uint32)[None, :]
        rows = (off[:, None] + j * gap[:, None]) % np.uint32(w)
        valid = j < d_item[:, None]
        return rows, valid

    def _cells(self, items: np.ndarray, rows: np.ndarray):
        """(row, column) int64 tensors on the device of every (item, j):
        the item's cell in each row of its subset."""
        cells = sk.compute_indices(self.spec.base, self.params, items)   # [w, B]
        r = torch.from_numpy(rows.astype(np.int64)).to(self.device)      # [B, max_d]
        b = torch.arange(rows.shape[0], device=self.device)[:, None].expand_as(r)
        return r, cells[r, b]

    # -- stream ops ---------------------------------------------------------
    def update(self, items: np.ndarray, freqs: np.ndarray) -> None:
        items = np.asarray(items, dtype=np.uint32)
        freqs = np.asarray(freqs, dtype=np.int64)
        keys = pack_keys(self.spec.base.schema, items)
        self.mg.offer(keys, freqs)
        heavy = self.mg.is_heavy(keys)
        rows, valid = self._rows(items, heavy)
        r, c = self._cells(items, rows)
        keep = torch.from_numpy(valid).to(self.device)
        f = torch.from_numpy(freqs).to(self.device)[:, None].expand_as(r)
        self.table.index_put_((r[keep], c[keep]), f[keep], accumulate=True)

    def query(self, items: np.ndarray) -> np.ndarray:
        """int64[B] estimates: the minimum over each item's row subset."""
        items = np.asarray(items, dtype=np.uint32)
        keys = pack_keys(self.spec.base.schema, items)
        heavy = self.mg.is_heavy(keys)
        rows, valid = self._rows(items, heavy)
        r, c = self._cells(items, rows)
        vals = self.table[r, c]
        vals = torch.where(torch.from_numpy(valid).to(self.device), vals,
                           torch.iinfo(torch.int64).max)
        return vals.min(dim=1).values.cpu().numpy()


def fcm_spec(schema: KeySchema, h: int, w: int, mg_k: int = 256,
             d_hf: Optional[int] = None, d_lf: Optional[int] = None) -> FCMSpec:
    """FCM: Count-Min cell indexing + frequency-aware row subsets."""
    d_hf = d_hf or max(1, w // 3)
    d_lf = d_lf or max(d_hf + 1, (2 * w) // 3)
    return FCMSpec(base=sk.count_min_spec(schema, h, w), d_hf=d_hf, d_lf=d_lf, mg_k=mg_k)


def fmod_spec(schema: KeySchema, partition, ranges, w: int, mg_k: int = 256,
              d_hf: Optional[int] = None, d_lf: Optional[int] = None) -> FCMSpec:
    """FMOD: MOD-Sketch composite cell indexing under FCM row selection."""
    d_hf = d_hf or max(1, w // 3)
    d_lf = d_lf or max(d_hf + 1, (2 * w) // 3)
    return FCMSpec(base=sk.mod_sketch_spec(schema, partition, ranges, w),
                   d_hf=d_hf, d_lf=d_lf, mg_k=mg_k)
