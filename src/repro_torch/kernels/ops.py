"""Public wrappers around the sketch kernels, PyTorch port (linear and
signed modes).

Port of ``repro/kernels/ops.py``.  These adapt the ``SketchSpec`` /
``HierarchySpec`` API to the kernels: chunk extraction, the padded table
layout, sub-blocking, and state interop with the plain paths.  On CUDA
tensors every fold and query launches a hand-written kernel (K1-K3, K6-K8
and K7m here; K4, K9 and K9m through core/hierarchy.py and
core/countsketch.py);
on CPU tensors the same calls run the kernels' plain versions.  Linear
and signed tables may be int32 or float32 (``dtype``): float32 folds
launch K1f, K3f, K6f and K8f, and float32 frequencies are unconstrained.

``mode="signed"`` is the Count-Sketch variant (core/countsketch.py): the
same fold with a per-group composite +-1 sign, a median-of-rows estimator
on the query side, and signed (turnstile) frequencies allowed on int
tables.  Signed tables are linear, so they merge cell-wise.

The padded table width (``tile_h``) is kept although no CUDA kernel needs
it: it makes the port's tables and ``state_dict`` arrays interchangeable
with the reference's.  Blocks are not padded: zero-frequency pad rows are
no-ops, so the reference's fixed-length padding changes nothing but the
work done.

``mode="conservative"`` is the Estan-Varghese update: strictly tighter
estimates on insert-only streams, but the table is NOT linear in the
stream, so ``merge``/``state()`` are refused; queries are unchanged (K2).
Every block is folded by K5 (kernels/sketch_update_conservative.py), in
shared memory when the table fits one CTA's and in global memory
otherwise, a large block there in claim rounds across the card; every
route is the hand-written kernel.  int32 and float32
tables are both exact there.  ``sharded_update`` folds a block sharded
over a device mesh (linear and signed modes; core/distributed.py).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import countsketch as cs
from repro_torch.core import hierarchy as hh
from repro_torch.core.distributed import require_linear
from repro_torch.core import sketch as sk
from repro_torch.device import DeviceLike, as_index_tensor, numpy_dtype_name
from repro_torch.kernels.hashes import make_plan
from repro_torch.kernels.hier_update import (
    hier_update,
    hier_update_signed,
    make_hier_plan,
)
from repro_torch.kernels.sketch_query import (
    sketch_query,
    sketch_query_signed,
    sketch_query_signed_median,
)
from repro_torch.kernels.sketch_update import (
    padded_table_size,
    sketch_update,
    sketch_update_signed,
)
from repro_torch.kernels.sketch_update_conservative import (
    round_scratch,
    sketch_update_conservative,
)
from repro_torch.staging import StagingRing
from repro_torch.tracing import span

_MAX_KERNEL_FREQ = 1 << 24  # the reference's two 12-bit limbs

MODES = ("linear", "conservative", "signed")


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex)


def check_linear_kernel_freqs(freqs: np.ndarray, table_dtype) -> None:
    """Reject frequencies the linear kernels refuse, as the reference does.

    The reference's int path splits frequencies into two 12-bit limbs that
    are exact only for |f| < 2^24, and refuses negatives.  int32 atomics
    would take both, but the port keeps the same refusals and messages so
    the two packages accept the same streams.  Float tables are
    unconstrained.
    """
    if freqs.size == 0 or not _is_integer(table_dtype):
        return
    if np.abs(freqs).max() >= _MAX_KERNEL_FREQ:
        raise ValueError(
            "per-arrival |frequency| >= 2^24 overflows the int-table "
            "limb split: use the core.sketch path")
    if freqs.min() < 0:
        raise ValueError(
            "negative frequencies are not supported on int tables: "
            "use the core.sketch path (or a float32 table)")


def check_signed_kernel_freqs(freqs: np.ndarray, table_dtype) -> None:
    """Signed-mode frequency guard: negatives are the point (turnstile), so
    only the reference's limb-split magnitude bound applies.  int32 atomics
    need no limb split, but the port keeps the reference's contract and
    message."""
    if freqs.size == 0 or not _is_integer(table_dtype):
        return
    if np.abs(freqs).max() >= _MAX_KERNEL_FREQ:
        raise ValueError(
            "per-arrival |frequency| >= 2^24 overflows the int-table "
            "limb split: use the core.countsketch path")


def _as_uint32(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(np.uint32)


class KernelSketch:
    """Flat sketch whose table lives padded for the kernels (K1/K2, K5/K2
    in conservative mode, or K6/K7m in signed mode, K7 for its rows).

    ``params``: a ``torch.Generator`` or, in place of the reference's jax
    key, the arrays of a draw -- ``(q, r)`` in linear mode, ``(q, r,
    sign_q, sign_r)`` (or a ``CountSketchParams``) in signed mode, numpy or
    tensors.  ``block_b`` is the most rows one launch folds.  ``staging``
    is the page-locked ring (``repro_torch.staging``) through which
    :meth:`update` sends host blocks to a table on the card, with its
    counters ``staged_blocks`` and ``staging_waits``.  ``fold_scratch``
    (conservative mode, a table on the card that K5's claim rounds may
    fold; else None) is their scratch, with its counter ``stats``.
    """

    def __init__(self, spec: sk.SketchSpec, params, *, tile_h: int = 512,
                 block_b: int = 1 << 16, dtype=torch.int32,
                 device: DeviceLike = None, mode: str = "linear"):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.spec = spec
        self.plan = make_plan(spec)
        self.mode = mode
        if mode == "signed":
            self.cs_params = cs.resolve_params(spec, params, device)
            self.params = self.cs_params.base
        else:
            self.cs_params = None
            self.params = sk.resolve_params(spec, params, device)
        self.tile_h = int(tile_h)
        self.block_b = int(block_b)
        self.h_pad = padded_table_size(spec.table_size, tile_h)
        self.table = torch.zeros((spec.width, self.h_pad), dtype=dtype,
                                 device=self.params.q.device)
        self.staging = StagingRing()
        self.fold_scratch = round_scratch(self.table) if mode == "conservative" else None

    @property
    def device(self) -> torch.device:
        return self.table.device

    # -- stream ops ---------------------------------------------------------
    def _check_freqs(self, freqs: np.ndarray) -> None:
        """Reject frequencies the mode's kernel refuses: the limb-split
        bounds of the linear and signed kernels, and the conservative
        fold's non-negativity and table-range checks."""
        if self.mode == "conservative":
            sk.check_conservative_freqs(freqs, self.table.dtype)
        elif self.mode == "signed":
            check_signed_kernel_freqs(freqs, self.table.dtype)
        else:
            check_linear_kernel_freqs(freqs, self.table.dtype)

    def update(self, items, freqs) -> None:
        """Fold a block of keys ``items`` [B, n_modules] (uint32) with
        ``freqs`` [B], in stream order; one launch per ``block_b`` rows.

        Host arrays bound for a table on the card cross through
        :attr:`staging`: copied into a page-locked slot before the call
        returns, then to the card without a synchronise, so the call
        returns while the card still folds and the host prepares the next
        block meanwhile.  Tensors already on the card, and every block of a
        CPU table, are taken as they are.  The frequencies are checked on
        the host first; a refused block raises before anything is staged.
        """
        with span("repro_torch.ingest.update"):
            on_card = isinstance(items, torch.Tensor) and items.is_cuda
            if not on_card:
                items = np.asarray(items, dtype=np.uint32)
                freqs = np.asarray(freqs)
            with span("repro_torch.ingest.check"):
                self._check_freqs(freqs.cpu().numpy() if isinstance(freqs, torch.Tensor)
                                  else freqs)
            if items.shape[0] == 0:
                return
            staged = not on_card and self.device.type == "cuda"
            with span("repro_torch.ingest.keys"):
                if staged:
                    slot = self.staging.take(self.device)
                    keys = slot.send("keys", items).to(torch.int64)
                else:
                    keys = as_index_tensor(items, self.device)
                chunks = self.spec.schema.module_chunks(keys)
            with span("repro_torch.ingest.freqs"):
                f = slot.send("freqs", freqs) if staged else sk.as_freqs(freqs, self.device)
                f = f.to(self.table.dtype)
            q, r = self.params
            for s in range(0, items.shape[0], self.block_b):
                blk_c, blk_f = chunks[s : s + self.block_b], f[s : s + self.block_b]
                if self.mode == "signed":
                    sketch_update_signed(self.plan, self.table, blk_c, blk_f, q, r,
                                         self.cs_params.sign_q, self.cs_params.sign_r)
                elif self.mode == "conservative":
                    sketch_update_conservative(self.plan, self.table, blk_c, blk_f, q, r,
                                               self.fold_scratch)
                else:
                    sketch_update(self.plan, self.table, blk_c, blk_f, q, r)

    def query(self, items) -> np.ndarray:
        """Point estimates: min over rows, int32[Q] (linear and
        conservative: K2), or the unbiased median over signed rows,
        float32[Q] (signed mode: K7m, the rows and their median in one
        launch, on int32 tables).  A float32 table is read as int32 by K2,
        as the reference's query kernel casts it; a float32 signed table
        takes the plain gather and ``median_rows``."""
        if self.mode == "signed":
            if self.table.dtype != torch.int32:
                return cs.median_rows(self._signed_rows(items)).cpu().numpy()
            est = sketch_query_signed_median(self.plan, self.table, self._chunks(items),
                                             self.params.q, self.params.r,
                                             self.cs_params.sign_q, self.cs_params.sign_r)
            return est.cpu().numpy()
        est = sketch_query(self.plan, self.table.to(torch.int32), self._chunks(items),
                           self.params.q, self.params.r)
        return est.cpu().numpy()

    def query_rows(self, items) -> np.ndarray:
        """Signed mode only: per-row signed estimates [w, Q] (int32 on
        int32 tables, float32 on float32 tables), the medians' raw
        material."""
        if self.mode != "signed":
            raise ValueError("query_rows is the signed-mode estimator; "
                             "linear/conservative sketches use query()")
        return self._signed_rows(items).cpu().numpy()

    def _chunks(self, items) -> torch.Tensor:
        items = np.asarray(items, dtype=np.uint32)
        return self.spec.schema.module_chunks(as_index_tensor(items, self.device))

    def _signed_rows(self, items) -> torch.Tensor:
        """K7 on int32 tables; float tables take the plain gather of
        ``countsketch.query_rows``, as the reference's do (its K7 reads
        int32 tables only)."""
        if self.table.dtype != torch.int32:
            items = np.asarray(items, dtype=np.uint32)
            return cs.query_rows(self.spec, self.cs_state(), items)[0]
        return sketch_query_signed(self.plan, self.table, self._chunks(items),
                                   self.params.q, self.params.r, self.cs_params.sign_q,
                                   self.cs_params.sign_r)

    def sharded_update(self, mesh, data_axes, items, freqs) -> None:
        """Distributed fold: shard the block over ``mesh``'s ``data_axes``
        (padded with :func:`~repro_torch.core.distributed.pad_block_pow2`,
        as the reference pads it), fold each shard's slice on its device
        (one K1 launch a shard in linear mode, K6 in signed mode; K1f/K6f
        on float32), psum-merge the deltas and add them to the table.

        Linear and signed modes: the conservative table is not linear in
        the stream, so its sharded folds cannot be psum-merged.  As in the
        reference, the kernels' frequency bounds are not applied here (the
        reference folds this path with its exact jnp scatter)."""
        from repro_torch.core import distributed as dist

        require_linear(self.mode, "KernelSketch.sharded_update")
        items = np.asarray(items, dtype=np.uint32)
        freqs = np.asarray(freqs)
        items, freqs, _ = dist.pad_block_pow2(items, freqs, mesh.axis_size(data_axes))
        if self.mode == "signed":
            delta = dist.sharded_signed_build(self.spec, self.cs_params, mesh,
                                              tuple(data_axes), items, freqs,
                                              table_dtype=self.table.dtype)
        else:
            delta = dist.sharded_build(self.spec, self.params, mesh, tuple(data_axes),
                                       items, freqs, table_dtype=self.table.dtype)
        self.table[:, : self.spec.table_size].add_(delta.to(self.device))

    # -- interop ------------------------------------------------------------
    def merge(self, other: "KernelSketch") -> None:
        """Cell-wise merge (cross-shard fold); linear and signed tables are
        both linear in the stream.  Conservative tables are not -- the sum
        of two conservatively built tables is not the table of the joined
        stream -- so merging them is refused in either direction."""
        if self.mode == "conservative" or other.mode == "conservative":
            raise ValueError(
                "merge is only defined for linear-table sketches (linear "
                "or signed mode): conservative tables are not linear in "
                "the stream")
        if self.mode != other.mode:
            raise ValueError(
                "merge requires identical modes (a min-estimated and a "
                "median-estimated table are different objects even though "
                "both are linear)")
        if self.spec != other.spec or self.h_pad != other.h_pad:
            raise ValueError("merge requires identical specs and padding")
        if self.table.dtype != other.table.dtype:
            raise ValueError(
                "merge requires identical table dtypes (an int32+float32 "
                "sum would silently promote and lose exact counts)")
        if not (torch.equal(self.params.q, other.params.q.to(self.device))
                and torch.equal(self.params.r, other.params.r.to(self.device))):
            raise ValueError(
                "merge requires identical hash params (same spec and key)")
        if self.mode == "signed" and not (
                torch.equal(self.cs_params.sign_q,
                            other.cs_params.sign_q.to(self.device))
                and torch.equal(self.cs_params.sign_r,
                                other.cs_params.sign_r.to(self.device))):
            raise ValueError(
                "merge requires identical sign-hash params (same spec "
                "and key)")
        self.table = self.table + other.table.to(self.device)

    def state(self) -> sk.SketchState:
        """Unpadded SketchState view (for merge with the plain path).

        Linear mode only: conservative tables must not enter the cell-wise
        merge path, and signed tables carry sign params a SketchState
        cannot hold (:meth:`cs_state`)."""
        if self.mode != "linear":
            raise ValueError(
                "state() feeds the min-estimated SketchState cell-wise merge "
                "path; conservative tables must not enter it and signed "
                "tables carry sign params it cannot hold -- use cs_state() "
                "(signed) or table_view()/query()")
        return sk.SketchState(params=self.params,
                              table=self.table[:, : self.spec.table_size])

    def cs_state(self) -> cs.CountSketchState:
        """Unpadded CountSketchState view (signed mode's merge/reference
        currency, the analogue of :meth:`state`)."""
        if self.mode != "signed":
            raise ValueError("cs_state() is the signed-mode view; "
                             "linear sketches use state()")
        return cs.CountSketchState(params=self.cs_params,
                                   table=self.table[:, : self.spec.table_size])

    def table_view(self) -> np.ndarray:
        """Read-only unpadded table copy (inspection/tests)."""
        return self.table[:, : self.spec.table_size].cpu().numpy()

    # -- durable state --------------------------------------------------------
    def _fingerprint(self) -> np.ndarray:
        # numpy's dtype name, as the reference prints its jnp dtype
        return np.frombuffer(
            (f"kernel|{self.spec!r}|mode={self.mode}"
             f"|dtype={numpy_dtype_name(self.table.dtype)}|h_pad={self.h_pad}"
             ).encode(), dtype=np.uint8).copy()

    def state_dict(self) -> dict:
        """Padded table + every hash param the mode uses as ``{key:
        ndarray}`` (sign params too in signed mode); loads into the
        reference's ``KernelSketch.load_state_dict`` and back."""
        out = {"meta.fingerprint": self._fingerprint(),
               "table": self.table.cpu().numpy(),
               "params.q": _as_uint32(self.params.q),
               "params.r": _as_uint32(self.params.r)}
        if self.mode == "signed":
            out["params.sign_q"] = _as_uint32(self.cs_params.sign_q)
            out["params.sign_r"] = _as_uint32(self.cs_params.sign_r)
        return out

    def load_state_dict(self, sd: dict) -> None:
        """Restore a state saved by this class or by the reference's
        ``KernelSketch.state_dict``; bit-exact round trip."""
        fp = self._fingerprint()
        got = np.asarray(sd["meta.fingerprint"], dtype=np.uint8)
        if not np.array_equal(fp, got):
            raise ValueError(
                "kernel state_dict fingerprint mismatch: saved "
                f"{bytes(got).decode(errors='replace')!r}, this sketch is "
                f"{bytes(fp).decode(errors='replace')!r}")
        self.table = torch.from_numpy(np.array(sd["table"])).to(self.device)
        if self.mode == "signed":
            self.cs_params = cs.resolve_params(
                self.spec, (sd["params.q"], sd["params.r"], sd["params.sign_q"],
                            sd["params.sign_r"]), self.device)
            self.params = self.cs_params.base
        else:
            self.params = sk.resolve_params(
                self.spec, (sd["params.q"], sd["params.r"]), self.device)


class KernelHierarchy:
    """Hierarchy whose level tables live concatenated + padded for the fused
    single-launch update (K3, or K8 in signed mode; kernels/hier_update.py).

    Every stream block is folded into ALL levels by one launch against the
    ``[w, sum_L h_L_pad]`` table, hashing each item once per row.
    :meth:`state` (linear) and :meth:`cs_state` (signed) hand out the
    standard ``HierarchyState`` / ``CountSketchHierarchy`` views (per level:
    a strided view of the table + prefix-sliced shared params), cached until
    the next ingest, so the descent runs unchanged on them -- K4 and K9 read
    the level views in place.

    ``params``: a ``torch.Generator`` or the finest level's arrays, ``(q,
    r)`` in linear mode and ``(q, r, sign_q, sign_r)`` in signed mode.
    """

    def __init__(self, hspec, params, *, tile_h: int = 512,
                 block_b: int = 1 << 16, dtype=torch.int32,
                 device: DeviceLike = None, mode: str = "linear"):
        if mode not in ("linear", "signed"):
            raise ValueError(
                "KernelHierarchy modes are 'linear' and 'signed' "
                "(conservative hierarchies take "
                f"core.hierarchy.update_conservative), got {mode!r}")
        self.hspec = hspec
        self.hplan = make_hier_plan(hspec, tile_h)
        self.mode = mode
        if mode == "signed":
            self.cs_params = cs.resolve_params(hspec.levels[-1], params, device)
            self.params = self.cs_params.base
        else:
            self.cs_params = None
            self.params = sk.resolve_params(hspec.levels[-1], params, device)
        self.block_b = int(block_b)
        self.table = torch.zeros((hspec.base.width, self.hplan.padded_cols),
                                 dtype=dtype, device=self.params.q.device)
        self._state_cache = None

    @classmethod
    def from_state(cls, hspec, state, *, tile_h: int = 512,
                   block_b: int = 1 << 16) -> "KernelHierarchy":
        """Adopt an existing (shared-params) HierarchyState's tables+params,
        on the device they live on."""
        self = cls.__new__(cls)
        self.hspec = hspec
        self.hplan = make_hier_plan(hspec, tile_h)
        self.mode = "linear"   # HierarchyState carries no sign params
        self.cs_params = None
        self.block_b = int(block_b)
        self._state_cache = None
        self.load_state(state)
        return self

    # -- state interop -------------------------------------------------------
    def load_state(self, state) -> None:
        """Pack a HierarchyState into the concatenated padded table (a copy).

        The state must carry the shared-prefix params of ``init_hierarchy``:
        the fused kernel hashes with the finest params only and derives
        every level by division.  Linear mode only: a HierarchyState has
        no sign params.
        """
        if self.mode != "linear":
            raise ValueError(
                "load_state() takes a (sign-less) HierarchyState and is "
                "linear-mode only; signed hierarchies are built by ingest "
                "from their own key")
        if not hh.params_share_prefix(state):
            raise ValueError(
                "KernelHierarchy requires the shared per-group hash family "
                "(level params must be prefix slices of the finest "
                "level's, as drawn by init_hierarchy)")
        fine = state.states[-1].params
        self.params = sk.SketchParams(q=fine.q.contiguous(), r=fine.r.contiguous())
        parts = []
        for st_l, h_l, pad_l in zip(state.states, self.hplan.level_sizes,
                                    self.hplan.level_pads):
            if st_l.table.shape[1] != h_l:
                raise ValueError("state tables do not match the spec")
            parts.append(torch.nn.functional.pad(st_l.table, (0, pad_l - h_l)))
        self.table = torch.cat(parts, dim=1)
        self._state_cache = None

    def _level_views(self):
        return tuple(self.table[:, off : off + h_l]
                     for off, h_l in zip(self.hplan.level_offsets,
                                         self.hplan.level_sizes))

    def state(self) -> hh.HierarchyState:
        """HierarchyState view (sliced, unpadded); cached until next ingest.

        Linear mode only: HierarchyState is the min-estimated descent/merge
        currency and carries no sign params -- the signed view is
        :meth:`cs_state`."""
        if self.mode != "linear":
            raise ValueError(
                "state() is the linear (Count-Min) hierarchy view; signed "
                "hierarchies use cs_state()")
        if self._state_cache is None:
            self._state_cache = hh.HierarchyState(states=tuple(
                sk.SketchState(params=hh.level_params(self.hspec, self.params, l),
                               table=view)
                for l, view in enumerate(self._level_views())))
        return self._state_cache

    def cs_state(self) -> cs.CountSketchHierarchy:
        """CountSketchHierarchy view (per level a strided view of the table,
        no copy); cached until the next ingest -- feeds the signed
        candidate queries and threshold descent
        (core.countsketch.candidate_estimates / find_heavy_hitters)."""
        if self.mode != "signed":
            raise ValueError("cs_state() is the signed hierarchy view; "
                             "linear hierarchies use state()")
        if self._state_cache is None:
            self._state_cache = cs.CountSketchHierarchy(
                params=self.cs_params, tables=self._level_views())
        return self._state_cache

    # -- ingest --------------------------------------------------------------
    def update(self, items, freqs) -> None:
        """Fold a weighted block: one fused launch per ``block_b`` rows."""
        items = np.asarray(items, dtype=np.uint32)
        freqs = np.asarray(freqs)
        if self.mode == "signed":
            check_signed_kernel_freqs(freqs, self.table.dtype)
        else:
            check_linear_kernel_freqs(freqs, self.table.dtype)
        if items.shape[0] == 0:
            return
        device = self.table.device
        schema = self.hspec.levels[-1].schema
        # group-major column order = the finest level's chunk layout
        ordered = self.hspec.level_items(self.hspec.n_levels - 1,
                                         as_index_tensor(items, device))
        chunks = schema.module_chunks(ordered)
        f = sk.as_freqs(freqs, device).to(self.table.dtype)
        q, r = self.params
        for s in range(0, items.shape[0], self.block_b):
            blk_c, blk_f = chunks[s : s + self.block_b], f[s : s + self.block_b]
            if self.mode == "signed":
                hier_update_signed(self.hplan, self.table, blk_c, blk_f, q, r,
                                   self.cs_params.sign_q, self.cs_params.sign_r)
            else:
                hier_update(self.hplan, self.table, blk_c, blk_f, q, r)
        self._state_cache = None
