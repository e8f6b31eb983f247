"""Carrying state across from the JAX reference (numpy arrays in, tensors out).

The reference draws hash params with ``jax.random``, which torch cannot
reproduce, so shared state crosses as arrays: a reference state's params
and tables (``np.asarray`` of its jax arrays, or its ``state_dict()``
entries) become the port's int64 params and tables here -- Count-Min and
signed (Count-Sketch) alike.  The
endpoints' and ``KernelSketch``'s ``load_state_dict`` also take the
reference's own ``state_dict()`` output verbatim, and their
``state_dict()`` loads back into the reference.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core import countsketch as cs
from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.device import DeviceLike, as_index_tensor, resolve_device


def params_from_numpy(q: np.ndarray, r: np.ndarray,
                      device: DeviceLike = None) -> sk.SketchParams:
    """uint32 hash params (q[w, C], r[w, m]) as the port's int64 tensors."""
    device = resolve_device(device)
    return sk.SketchParams(q=as_index_tensor(q, device),
                           r=as_index_tensor(r, device))


def hierarchy_state_from_numpy(hspec: hh.HierarchySpec, q: np.ndarray,
                               r: np.ndarray, tables: Sequence[np.ndarray],
                               device: DeviceLike = None) -> hh.HierarchyState:
    """A HierarchyState from the finest level's params and one table per
    level (coarse to fine); every level's params are the shared prefix
    slices, as ``init_hierarchy`` draws them."""
    if len(tables) != hspec.n_levels:
        raise ValueError(f"need {hspec.n_levels} level tables, got {len(tables)}")
    base = params_from_numpy(q, r, device)
    return hh.HierarchyState(states=tuple(
        sk.SketchState(params=hh.level_params(hspec, base, l),
                       table=torch.from_numpy(np.array(t)).to(base.q.device))
        for l, t in enumerate(tables)))


def countsketch_params_from_numpy(q: np.ndarray, r: np.ndarray,
                                  sign_q: np.ndarray, sign_r: np.ndarray,
                                  device: DeviceLike = None) -> cs.CountSketchParams:
    """A reference ``CountSketchParams`` (``base.q``, ``base.r``, ``sign_q``,
    ``sign_r``, uint32) as the port's int64 tensors."""
    device = resolve_device(device)
    return cs.CountSketchParams(
        base=params_from_numpy(q, r, device),
        sign_q=as_index_tensor(sign_q, device),
        sign_r=as_index_tensor(sign_r, device))


def countsketch_hierarchy_from_numpy(
        hspec: hh.HierarchySpec, q: np.ndarray, r: np.ndarray,
        sign_q: np.ndarray, sign_r: np.ndarray, tables: Sequence[np.ndarray],
        device: DeviceLike = None) -> cs.CountSketchHierarchy:
    """A ``CountSketchHierarchy`` from the finest level's bucket and sign
    params and one table per level (coarse to fine), as the reference's
    ``CountSketchHierarchy`` holds them."""
    if len(tables) != hspec.n_levels:
        raise ValueError(f"need {hspec.n_levels} level tables, got {len(tables)}")
    params = countsketch_params_from_numpy(q, r, sign_q, sign_r, device)
    return cs.CountSketchHierarchy(params, tuple(
        torch.from_numpy(np.array(t)).to(params.sign_q.device) for t in tables))
