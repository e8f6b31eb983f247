"""Public wrappers around the sketch kernels, PyTorch port (linear mode).

Port of ``repro/kernels/ops.py``.  These adapt the ``SketchSpec`` /
``HierarchySpec`` API to the kernels: chunk extraction, the padded table
layout, sub-blocking, and state interop with the plain paths.  On CUDA
tensors every fold and query launches a hand-written kernel (K1-K3 here;
K4 through core/hierarchy.py); on CPU tensors the same calls run the
kernels' plain versions.

The padded table width (``tile_h``) is kept although no CUDA kernel needs
it: it makes the port's tables and ``state_dict`` arrays interchangeable
with the reference's.  Blocks are not padded: zero-frequency pad rows are
no-ops, so the reference's fixed-length padding changes nothing but the
work done.  Conservative and signed modes arrive with later slices
(ROADMAP items 9 and 10).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.device import DeviceLike, as_index_tensor, numpy_dtype_name
from repro_torch.kernels.hashes import make_plan
from repro_torch.kernels.hier_update import hier_update, make_hier_plan
from repro_torch.kernels.sketch_query import sketch_query
from repro_torch.kernels.sketch_update import padded_table_size, sketch_update

_MAX_KERNEL_FREQ = 1 << 24  # the reference's two 12-bit limbs

MODES = ("linear", "conservative", "signed")
_LATER_MODES = {"conservative": "ROADMAP item 9", "signed": "ROADMAP item 10"}


def _require_linear_mode(mode: str, what: str) -> None:
    if mode in _LATER_MODES:
        raise NotImplementedError(
            f"{what} mode={mode!r} is not ported yet ({_LATER_MODES[mode]})")
    if mode != "linear":
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


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


def _params_numpy(params: sk.SketchParams):
    return (params.q.cpu().numpy().astype(np.uint32),
            params.r.cpu().numpy().astype(np.uint32))


class KernelSketch:
    """Flat sketch whose table lives padded for the kernels (K1/K2).

    ``params``: a ``torch.Generator`` or a ``(q, r)`` pair (numpy or
    tensors), in place of the reference's jax key.  ``block_b`` is the
    most rows one launch folds.
    """

    def __init__(self, spec: sk.SketchSpec, params, *, tile_h: int = 512,
                 block_b: int = 1 << 16, dtype=torch.int32,
                 device: DeviceLike = None, mode: str = "linear"):
        _require_linear_mode(mode, "KernelSketch")
        self.spec = spec
        self.plan = make_plan(spec)
        self.params = sk.resolve_params(spec, params, device)
        self.tile_h = int(tile_h)
        self.block_b = int(block_b)
        self.h_pad = padded_table_size(spec.table_size, tile_h)
        self.table = torch.zeros((spec.width, self.h_pad), dtype=dtype,
                                 device=self.params.q.device)
        self.mode = mode

    @property
    def device(self) -> torch.device:
        return self.table.device

    # -- stream ops ---------------------------------------------------------
    def update(self, items, freqs) -> None:
        items = np.asarray(items, dtype=np.uint32)
        freqs = np.asarray(freqs)
        check_linear_kernel_freqs(freqs, self.table.dtype)
        if items.shape[0] == 0:
            return
        chunks = self.spec.schema.module_chunks(as_index_tensor(items, self.device))
        f = sk.as_freqs(freqs, self.device).to(self.table.dtype)
        for s in range(0, items.shape[0], self.block_b):
            sketch_update(self.plan, self.table, chunks[s : s + self.block_b],
                          f[s : s + self.block_b], self.params.q, self.params.r)

    def query(self, items) -> np.ndarray:
        """Point estimates: min over rows, int32[Q]."""
        items = np.asarray(items, dtype=np.uint32)
        chunks = self.spec.schema.module_chunks(as_index_tensor(items, self.device))
        est = sketch_query(self.plan, self.table, chunks, self.params.q,
                           self.params.r)
        return est.cpu().numpy()

    # -- interop ------------------------------------------------------------
    def merge(self, other: "KernelSketch") -> None:
        """Cell-wise merge (cross-shard fold)."""
        if self.mode != other.mode:
            raise ValueError("merge requires identical modes")
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
        self.table = self.table + other.table.to(self.device)

    def state(self) -> sk.SketchState:
        """Unpadded SketchState view (for merge with the plain path)."""
        return sk.SketchState(params=self.params,
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
        """Padded table + hash params as ``{key: ndarray}``; loads into the
        reference's ``KernelSketch.load_state_dict`` and back."""
        q, r = _params_numpy(self.params)
        return {"meta.fingerprint": self._fingerprint(),
                "table": self.table.cpu().numpy(),
                "params.q": q, "params.r": r}

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
        self.params = sk.resolve_params(
            self.spec, (sd["params.q"], sd["params.r"]), self.device)


class KernelHierarchy:
    """Hierarchy whose level tables live concatenated + padded for the fused
    single-launch update (K3, kernels/hier_update.py).

    Every stream block is folded into ALL levels by one launch against the
    ``[w, sum_L h_L_pad]`` table, hashing each item once per row.
    :meth:`state` hands out the standard ``HierarchyState`` view (per level:
    a strided view of the table + prefix-sliced shared params), cached until
    the next ingest, so the descent runs unchanged on it -- K4 reads the
    level views in place.
    """

    def __init__(self, hspec, params, *, tile_h: int = 512,
                 block_b: int = 1 << 16, dtype=torch.int32,
                 device: DeviceLike = None, mode: str = "linear"):
        _require_linear_mode(mode, "KernelHierarchy")
        self.hspec = hspec
        self.hplan = make_hier_plan(hspec, tile_h)
        self.mode = mode
        self.params = sk.resolve_params(hspec.levels[-1], params, device)
        self.block_b = int(block_b)
        self.table = torch.zeros((hspec.base.width, self.hplan.padded_cols),
                                 dtype=dtype, device=self.params.q.device)
        self._state_cache: Optional[hh.HierarchyState] = None

    @classmethod
    def from_state(cls, hspec, state, *, tile_h: int = 512,
                   block_b: int = 1 << 16) -> "KernelHierarchy":
        """Adopt an existing (shared-params) HierarchyState's tables+params,
        on the device they live on."""
        self = cls.__new__(cls)
        self.hspec = hspec
        self.hplan = make_hier_plan(hspec, tile_h)
        self.mode = "linear"
        self.block_b = int(block_b)
        self._state_cache = None
        self.load_state(state)
        return self

    # -- state interop -------------------------------------------------------
    def load_state(self, state) -> None:
        """Pack a HierarchyState into the concatenated padded table (a copy).

        The state must carry the shared-prefix params of ``init_hierarchy``:
        the fused kernel hashes with the finest params only and derives
        every level by division.
        """
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

    def state(self) -> hh.HierarchyState:
        """HierarchyState view (sliced, unpadded); cached until next ingest."""
        if self._state_cache is None:
            states = []
            for l, (off, h_l) in enumerate(zip(self.hplan.level_offsets,
                                               self.hplan.level_sizes)):
                states.append(sk.SketchState(
                    params=hh.level_params(self.hspec, self.params, l),
                    table=self.table[:, off : off + h_l]))
            self._state_cache = hh.HierarchyState(states=tuple(states))
        return self._state_cache

    # -- ingest --------------------------------------------------------------
    def update(self, items, freqs) -> None:
        """Fold a weighted block: one fused launch per ``block_b`` rows."""
        items = np.asarray(items, dtype=np.uint32)
        freqs = np.asarray(freqs)
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
        for s in range(0, items.shape[0], self.block_b):
            hier_update(self.hplan, self.table, chunks[s : s + self.block_b],
                        f[s : s + self.block_b], self.params.q, self.params.r)
        self._state_cache = None
