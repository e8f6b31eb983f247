"""Sliding-window & time-decayed hierarchies: a ring of per-epoch tables.

Port of ``repro/core/window.py``.  Every level table of a (linearly built)
hierarchy is linear in the stream, so windowing is cell-wise arithmetic on
per-epoch tables:

    ring slot e : hierarchy tables of the items ingested during epoch e
    window      : merge of the live epochs' tables (expired epochs dropped
                  from the lazy merge, or subtracted from a running sum --
                  both exact by linearity on integer tables)

All epochs share ONE per-group hash family (the draw
``core.hierarchy.init_hierarchy`` makes for the ingest cascade), so epoch
tables are merge-compatible by construction: the merged window tables are
bit-identical to the tables of a hierarchy built over exactly the window's
stream contents.  Every query path of the hierarchy -- the descent on K4
(int32) or K4f (float32), the marginal queries -- runs unchanged against
the merged state.

Three window modes (:class:`WindowSpec.mode`): ``tumbling`` (the last
``n_epochs`` epochs, equally weighted), ``landmark`` (everything since boot:
expiring slots fold into a ``retired`` accumulator) and ``decay`` (an epoch
of age ``a`` weighs ``decay**a``; the merge is the Horner recurrence over
live epochs, oldest first, ``acc <- acc * decay + table_e``, on float32
tables).

Layout.  Where the reference holds a tuple of level tables per slot, the
port holds each ring slot, the ``retired`` accumulator (and the serving
layer's running sum) as ONE concatenated padded ``[w, sum_L h_L_pad]``
buffer of all levels, as ``kernels.ops.KernelHierarchy`` holds its table
(:attr:`WindowSpec.hplan`).  Merge, subtract and Horner are then one
elementwise op per stack, the epoch fold is one launch of the fused
hierarchy fold into the head slot -- K3 on int32 tables, K3f on float32,
CPU tensors taking its plain cascade -- and :func:`merged_state` hands out
level views of one merged buffer.  Folds update the head slot in place
(the reference donates it).

Linear mode only: conservative tables are not linear in the stream, so
every windowed entry point refuses ``mode="conservative"`` with
``core.distributed.require_linear``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.core.distributed import require_linear
from repro_torch.device import DeviceLike, as_index_tensor
from repro_torch.kernels import hier_update as hu


# --------------------------------------------------------------------------
# Spec
# --------------------------------------------------------------------------

_MODES = ("tumbling", "landmark", "decay")


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Static description of a windowed hierarchy.

    ``n_epochs`` is the ring capacity W: tumbling/decay windows cover the
    last W epochs, landmark keeps W live slots plus the retired
    accumulator.  ``decay`` is the per-epoch multiplier for mode="decay"
    (ignored otherwise)."""
    base: sk.SketchSpec
    n_epochs: int
    mode: str = "tumbling"
    decay: float = 1.0

    def __post_init__(self):
        if self.n_epochs < 1:
            raise ValueError("n_epochs >= 1 required")
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {self.mode!r}")
        if self.mode == "decay" and not (0.0 < self.decay <= 1.0):
            raise ValueError("decay in (0, 1] required for mode='decay'")

    @functools.cached_property
    def hspec(self) -> hh.HierarchySpec:
        return hh.HierarchySpec.from_spec(self.base)

    @functools.cached_property
    def hplan(self) -> hu.HierPlan:
        """The concatenated padded layout of one table stack."""
        return hu.make_hier_plan(self.hspec)


class WindowState(NamedTuple):
    """Ring of per-epoch table stacks sharing one hash family.

    ``level_params[l]`` is level l's prefix slice of the one shared draw;
    ``ring[e]`` is epoch slot e's stack, all levels in one ``[w,
    hplan.padded_cols]`` buffer; ``retired`` accumulates expired epochs in
    landmark mode and is ``None`` in the modes that never write it (the
    reference keeps zeros there); ``head`` is the slot receiving ingest;
    ``epoch`` counts advances since boot."""
    level_params: Tuple[sk.SketchParams, ...]
    ring: Tuple[torch.Tensor, ...]
    retired: Optional[torch.Tensor]
    head: int
    epoch: int


def level_views(wspec: WindowSpec, stack: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each level's ``[w, h_L]`` view of one table stack (no copy)."""
    hplan = wspec.hplan
    return tuple(stack[:, off : off + h]
                 for off, h in zip(hplan.level_offsets, hplan.level_sizes))


def pack_levels(wspec: WindowSpec, tables: Sequence[torch.Tensor]) -> torch.Tensor:
    """One stack buffer from per-level ``[w, h_L]`` tables (a copy)."""
    hplan = wspec.hplan
    if len(tables) != hplan.n_levels:
        raise ValueError(f"need {hplan.n_levels} level tables, got {len(tables)}")
    parts = []
    for t, h, pad in zip(tables, hplan.level_sizes, hplan.level_pads):
        if t.shape[1] != h:
            raise ValueError("level tables do not match the spec")
        parts.append(torch.nn.functional.pad(t, (0, pad - h)))
    return torch.cat(parts, dim=1)


def hier_state(wspec: WindowSpec, state: WindowState,
               stack: torch.Tensor) -> hh.HierarchyState:
    """A HierarchyState view over one table stack (shared params)."""
    return hh.HierarchyState(states=tuple(
        sk.SketchState(params=p, table=t)
        for p, t in zip(state.level_params, level_views(wspec, stack))))


def _default_dtype(wspec: WindowSpec, dtype):
    if dtype is None:
        return torch.float32 if wspec.mode == "decay" else torch.int32
    return dtype


def init_window(wspec: WindowSpec, params, *, dtype=None, mode: str = "linear",
                device: DeviceLike = None) -> WindowState:
    """Draw (or take) the shared hash family and zero every ring slot.

    ``params``: a ``torch.Generator`` or the finest level's ``(q, r)``
    arrays, as :func:`repro_torch.core.hierarchy.init_hierarchy` takes them.
    ``dtype`` defaults to int32 (exact integer arithmetic; merge and
    subtract are bit-exact) and to float32 for decay mode, whose scale
    leaves the integers (decay takes float32 alone).  ``mode`` exists only
    to be refused."""
    require_linear(mode, "window.init_window")
    dtype = _default_dtype(wspec, dtype)
    if wspec.mode == "decay" and not dtype.is_floating_point:
        raise ValueError(
            "decay mode scales tables by a float factor each epoch; use a "
            "float table dtype (int tables would truncate the decay)")
    if wspec.mode == "decay" and dtype != torch.float32:
        raise ValueError(
            f"decay mode keeps float32 tables (the reference's float tables "
            f"without x64), got {dtype}")
    base = sk.resolve_params(wspec.hspec.levels[-1], params, device)
    shape = (wspec.base.width, wspec.hplan.padded_cols)
    zeros = [torch.zeros(shape, dtype=dtype, device=base.q.device)
             for _ in range(wspec.n_epochs + (wspec.mode == "landmark"))]
    return WindowState(
        level_params=tuple(hh.level_params(wspec.hspec, base, l)
                           for l in range(wspec.hspec.n_levels)),
        ring=tuple(zeros[: wspec.n_epochs]),
        retired=zeros[-1] if wspec.mode == "landmark" else None, head=0, epoch=0)


# --------------------------------------------------------------------------
# Ingest / advance
# --------------------------------------------------------------------------

def block_chunks(wspec: WindowSpec, state: WindowState, items) -> torch.Tensor:
    """A key block's 16-bit chunks in the finest level's group-major layout,
    on the tables' device: the input of :func:`fold_chunks`."""
    hspec = wspec.hspec
    ordered = hspec.level_items(
        hspec.n_levels - 1, as_index_tensor(items, state.ring[0].device))
    return hspec.levels[-1].schema.module_chunks(ordered)


def fold_chunks(wspec: WindowSpec, state: WindowState, stack: torch.Tensor,
                chunks: torch.Tensor, freqs, *, use_update_kernel: bool = True) -> None:
    """Fold a chunked block into every level of ``stack``, in place: one
    launch of the fused fold (K3, or K3f on float32) with
    ``use_update_kernel``, its plain cascade on CPU tensors or without."""
    fine = state.level_params[-1]
    f = sk.as_freqs(freqs, stack.device).to(stack.dtype)
    fold = hu.hier_update if use_update_kernel else hu.hier_update_ref
    fold(wspec.hplan, stack, chunks, f, fine.q, fine.r)


def window_update(wspec: WindowSpec, state: WindowState, items, freqs, *,
                  mode: str = "linear", use_update_kernel: bool = True) -> WindowState:
    """Fold a weighted key block into the CURRENT epoch's tables, in place.

    One hash pass per (row, key) and every level's cell by mixed-radix
    division, as :func:`repro_torch.core.hierarchy.update_jit`; the head
    slot's stack is updated in place and the state returned."""
    require_linear(mode, "window.window_update")
    chunks = block_chunks(wspec, state, np.asarray(items, dtype=np.uint32))
    fold_chunks(wspec, state, state.ring[state.head], chunks, freqs,
                use_update_kernel=use_update_kernel)
    return state


def advance_window(wspec: WindowSpec, state: WindowState) -> WindowState:
    """Close the current epoch and open a fresh one.

    The slot the head moves into holds the OLDEST live epoch; its tables
    expire: dropped (zeroed) in tumbling/decay mode, folded into the
    ``retired`` accumulator in landmark mode.  Advancing before the ring is
    full expires an empty slot, a no-op by linearity.  In place."""
    new_head = (state.head + 1) % wspec.n_epochs
    expiring = state.ring[new_head]
    if wspec.mode == "landmark":
        state.retired.add_(expiring)
    expiring.zero_()
    return state._replace(head=new_head, epoch=state.epoch + 1)


# --------------------------------------------------------------------------
# Lazy query-time merge
# --------------------------------------------------------------------------

def live_slots(wspec: WindowSpec, state: WindowState) -> Tuple[int, ...]:
    """Ring slots of the live epochs, oldest -> newest (head last).

    Before the ring has wrapped, only ``epoch + 1`` slots have ever
    received ingest; Horner decay weights depend on the number of folded
    terms, so the slot list must be exact."""
    n_live = min(state.epoch + 1, wspec.n_epochs)
    return tuple((state.head - a) % wspec.n_epochs
                 for a in reversed(range(n_live)))


def merge_sum(stacks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Cell-wise sum of table stacks, left to right, in their dtype (int32
    wraps as the reference's jnp adds do); always a new buffer."""
    acc = stacks[0].clone()
    for s in stacks[1:]:
        acc.add_(s)
    return acc


def fma_f32(a: torch.Tensor, d: float, b: torch.Tensor) -> torch.Tensor:
    """``a * d + b`` on float32 tensors with ONE rounding, as a fused
    multiply-add rounds it, on any device.

    The product of two float32 values is exact in float64; the sum is
    rounded once there and its error recovered exactly (TwoSum), which
    settles the one case where rounding that float64 sum to float32 again
    could differ from the single rounding: a sum exactly halfway between
    two float32 values."""
    p = a.double() * float(np.float32(d))
    b64 = b.double()
    s = p + b64
    bv = s - p
    err = (p - (s - bv)) + (b64 - bv)
    r = s.float()
    diff = s - r.double()
    n = torch.nextafter(r, torch.where(diff > 0, torch.inf, -torch.inf).float())
    halfway = (diff != 0) & (s == (r.double() + n.double()) * 0.5)
    return torch.where(halfway & (err != 0) & ((err > 0) == (diff > 0)), n, r)


def merge_horner(decay: float, stacks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Scale-then-fold over table stacks, OLDEST FIRST: ``acc = acc * decay
    + table``, so age-a epochs carry weight decay**a; always a new buffer.

    Each step rounds once (:func:`fma_f32`), as the reference's jnp step
    does: XLA compiles its multiply and add into one fused multiply-add,
    from which the two-rounding form differs at decay 0.9.  Float32 stacks
    only, the decayed window's."""
    acc = stacks[0].clone()
    for s in stacks[1:]:
        acc = fma_f32(acc, decay, s)
    return acc


def merged_stack(wspec: WindowSpec, state: WindowState) -> torch.Tensor:
    """The window's merged table stack (a new buffer): tumbling sums the
    live slots, landmark adds ``retired`` first, decay runs Horner."""
    stacks = [state.ring[s] for s in live_slots(wspec, state)]
    if wspec.mode == "decay":
        return merge_horner(float(wspec.decay), stacks)
    if wspec.mode == "landmark":
        stacks = [state.retired] + stacks
    return merge_sum(stacks)


def merged_state(wspec: WindowSpec, state: WindowState) -> hh.HierarchyState:
    """The window's hierarchy, lazily merged from the live epoch tables: a
    HierarchyState of level views over one merged buffer, on which the
    descent and the marginal queries run unchanged.  For tumbling/landmark
    int tables it is bit-identical to a hierarchy built from scratch over
    the window's stream contents."""
    return hier_state(wspec, state, merged_stack(wspec, state))


def subtract_tables(window_sum: torch.Tensor, expiring: torch.Tensor) -> torch.Tensor:
    """The incremental-expiry primitive: a running window sum minus an
    expiring epoch's stack, one elementwise op for all levels (a new
    buffer).  Exact on integer tables by linearity, so a running sum kept
    this way stays bit-identical to the lazy resum.  Linear tables only."""
    return window_sum - expiring


# --------------------------------------------------------------------------
# Recompute-from-scratch reference (test oracle)
# --------------------------------------------------------------------------

def reference_window_state(wspec: WindowSpec, params, epoch_blocks, *, dtype=None,
                           device: DeviceLike = None) -> hh.HierarchyState:
    """Oracle: the merged window built from scratch, no ring involved.

    ``epoch_blocks`` must be the LIVE epochs' streams (oldest first).
    tumbling/landmark: one fresh hierarchy over the concatenation, by the
    plain per-level cascade (``core.hierarchy.update_jit``); decay: one
    fresh hierarchy per epoch, folded through the same Horner recurrence as
    :func:`merged_state` -- the identical float operations in the identical
    order, hence bit-exact.  Returns per-level tables (not views)."""
    dtype = _default_dtype(wspec, dtype)
    hspec = wspec.hspec
    blocks = [(np.asarray(i, dtype=np.uint32), np.asarray(f)) for i, f in epoch_blocks]

    def build(parts):
        state = hh.init_hierarchy(hspec, params, dtype=dtype, device=device)
        parts = [(i, f) for i, f in parts if len(i)]
        if parts:
            items = np.concatenate([i for i, _ in parts], axis=0)
            freqs = np.concatenate([f for _, f in parts])
            state = hh.update_jit(hspec, state, items, freqs)
        return state

    if wspec.mode != "decay":
        return build(blocks)
    if not blocks:
        return build([])
    states = [build([b]) for b in blocks]
    levels = []
    for l in range(hspec.n_levels):
        levels.append(merge_horner(float(wspec.decay),
                                   [st.states[l].table for st in states]))
    return hh.HierarchyState(states=tuple(
        sk.SketchState(params=s.params, table=t)
        for s, t in zip(states[-1].states, levels)))
