"""Carrying state across from the JAX reference (numpy arrays in, tensors out).

The reference draws hash params with ``jax.random``, which torch cannot
reproduce, so shared state crosses as arrays: a reference state's params
and tables (``np.asarray`` of its jax arrays, or its ``state_dict()``
entries) become the port's int64 params and tables here -- Count-Min and
signed (Count-Sketch) alike.  The
endpoints' and ``KernelSketch``'s ``load_state_dict`` also take the
reference's own ``state_dict()`` output verbatim, and their
``state_dict()`` loads back into the reference.

Training state crosses the same way: the reference's param tree as numpy
(stacked blocks included, bfloat16 bit for bit; every family's), a decode
cache the same way, the n-gram sketch's
``(q, r)`` and each compressed leaf's ``(q, r, sign_q, sign_r)`` keyed by
the leaf's path in the tree.

A reference ``WindowState`` (its level params and ring, as numpy) becomes
the port's concatenated per-slot buffers, and an FCM's params, table and
Misra-Gries counters cross the same way.  The windowed service's own
``load_state_dict`` takes the reference service's ``state_dict()``, and so
does the sharded service's (any saved shard count).  Durable state needs
no conversion: ``training/checkpoint.py`` and ``serving/recovery.py`` read
and write the reference's checkpoint and write-ahead-log formats.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree as tr
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


def window_state_from_numpy(wspec, q: np.ndarray, r: np.ndarray,
                            ring: Sequence[Sequence[np.ndarray]],
                            retired: Sequence[np.ndarray], head: int, epoch: int,
                            device: DeviceLike = None):
    """A ``core.window.WindowState`` from a reference ``WindowState`` as
    numpy: the finest level's params (``level_params[-1]``), each ring
    slot's level tables and the retired accumulator's (coarse to fine), and
    the clock.  Each slot becomes one concatenated padded buffer; the
    retired tables are taken in landmark mode only, the one mode that
    writes them."""
    from repro_torch.core import window as win

    base = params_from_numpy(q, r, device)
    dev = base.q.device

    def stack(tables):
        return win.pack_levels(wspec, [torch.from_numpy(np.array(t)).to(dev)
                                       for t in tables])

    if len(ring) != wspec.n_epochs:
        raise ValueError(f"need {wspec.n_epochs} ring slots, got {len(ring)}")
    return win.WindowState(
        level_params=tuple(hh.level_params(wspec.hspec, base, l)
                           for l in range(wspec.hspec.n_levels)),
        ring=tuple(stack(t) for t in ring),
        retired=stack(retired) if wspec.mode == "landmark" else None,
        head=int(head), epoch=int(epoch))


def fcm_from_numpy(spec, q: np.ndarray, r: np.ndarray, table: np.ndarray, *,
                   seed: int = 0, counters: Optional[Mapping[int, int]] = None,
                   mg_total: int = 0, device: DeviceLike = None):
    """A port ``core.fcm.FCM`` holding a reference FCM's state: its base
    params (``fcm.params.q``/``.r``), its int64 table, the ``seed`` it was
    built with (the offset and gap hashes) and its Misra-Gries counters
    (``fcm.mg.counters``, ``fcm.mg.total``)."""
    from repro_torch.core.fcm import FCM

    out = FCM(spec, (q, r), seed=seed, device=device)
    t = torch.from_numpy(np.asarray(table, dtype=np.int64)).to(out.device)
    if tuple(t.shape) != tuple(out.table.shape):
        raise ValueError(f"table {tuple(t.shape)} does not match the spec's "
                         f"{tuple(out.table.shape)}")
    out.table = t
    out.mg.counters = {int(k): int(v) for k, v in (counters or {}).items()}
    out.mg.total = int(mg_total)
    return out


# --------------------------------------------------------------------------
# training state
# --------------------------------------------------------------------------

def tensor_from_numpy(x: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """A numpy array as a tensor, bit for bit; bfloat16 arrays (the
    reference's ``np.asarray`` of a bf16 jax array) included."""
    device = resolve_device(device)
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(x).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(x)).to(device)


def model_params_from_numpy(cfg, tree: Mapping[str, Any],
                            device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's param tree for ``cfg`` (nested dicts of numpy
    arrays, ``jax.tree.map(np.asarray, params)``) as the port's params.
    Shapes and dtypes must match the port's own init for ``cfg``."""
    from repro_torch.models import transformer as tfm

    device = resolve_device(device)
    want = dict(tr.flatten(tfm.init_params(cfg, None, "meta")))
    got = tr.flatten(tree)
    if sorted(want) != [path for path, _ in got]:
        raise ValueError(f"param tree paths differ from {cfg.name}'s: "
                         f"{sorted(set(want) ^ {p for p, _ in got})}")
    out = []
    for path, leaf in got:
        t = tensor_from_numpy(leaf, device)
        if tuple(t.shape) != tuple(want[path].shape) or t.dtype != want[path].dtype:
            raise ValueError(f"{'/'.join(path)}: {tuple(t.shape)} {t.dtype}, "
                             f"{cfg.name} needs {tuple(want[path].shape)} "
                             f"{want[path].dtype}")
        out.append((path, t))
    return tr.unflatten(out)


def cache_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """A reference decode cache (``init_cache``'s or ``prefill``'s stacked
    tree, as numpy) as the port's: each leaf its own tensor, which
    ``decode_step`` then writes in place."""
    device = resolve_device(device)
    return tr.unflatten((path, tensor_from_numpy(leaf, device))
                        for path, leaf in tr.flatten(tree))


def compression_state_from_numpy(ccfg, params: Mapping[str, Any],
                                 draws: Mapping[Tuple[str, ...], Sequence[np.ndarray]]):
    """A fresh ``CompressionState`` for the port's ``params`` from each
    compressed leaf's ``(q, r, sign_q, sign_r)`` arrays, keyed by the
    leaf's path -- the reference's ``init_compression`` draw."""
    from repro_torch.training import grad_compression as gc

    return gc.init_compression(ccfg, params, draws)


def train_state_from_numpy(cfg, tcfg, params_tree: Mapping[str, Any],
                           sketch_qr: Optional[Sequence[np.ndarray]] = None,
                           compression_draws=None,
                           device: DeviceLike = None) -> Dict[str, Any]:
    """A fresh train state (zero optimizer moments, empty n-gram table, zero
    residuals) around the reference's params, n-gram sketch ``(q, r)`` and
    per-leaf compression draws -- what the reference's
    ``init_train_state`` builds from its key."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl

    params = model_params_from_numpy(cfg, params_tree, device)
    state: Dict[str, Any] = {"params": params,
                             "opt": opt.init_state(tcfg.optimizer, params)}
    device = tr.leaves(params)[0].device
    if tcfg.sketch_enabled:
        st = sk.init_state(tl.make_sketch_spec(cfg), tuple(sketch_qr), device=device)
        state["sketch_params"] = st.params
        state["sketch_table"] = st.table
    if tcfg.compression.enabled:
        state["compression"] = compression_state_from_numpy(
            tcfg.compression, params, compression_draws)
    return state
