"""Sharding rules: param/optimizer/batch/cache partition specs per mesh,
PyTorch port of ``repro/models/sharding.py``.

Layout: 2-D sharding -- tensor-parallel over ``model`` (attention heads,
FFN hidden, vocab, MoE expert FFN, SSD heads) x FSDP/ZeRO-3-style over the
data axes (``data`` or ``("pod", "data")``) on the other big dimension.
Every rule is path+rank based over the real param tree, so it applies
uniformly to the stacked-block layout (leading ``n_blocks`` dim -> spec
prepended with None).

Decode caches: batch over the data axes and *sequence over model*;
``long_500k`` (batch = 1) shards the sequence over every axis.  SSM decode
caches shard SSD heads over ``model``.

A spec is a :class:`P`, a tuple with one entry a dim: ``None``, an axis
name, or a tuple of names (the dim split over those axes, the first the
major one), as the reference's ``PartitionSpec``.  Paths are the
reference's: ``repro_torch.tree`` walks the same nested dicts, joined by
"/" (``blocks/layer_0/moe/w_in``).

In place of the reference's ``to_shardings`` (which only means something to
``jax.jit``), :func:`local_shape`, :func:`shard` and :func:`unshard` cut a
tensor into the slices the mesh positions hold and put them back together:
the dry-run counts bytes with them, and the single-controller mesh
(``launch/mesh.py``) places each position's slice on its device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.training.optimizer import Moment8

PyTree = Any


class P(tuple):
    """A partition spec: ``P("model", ("pod", "data"), None)``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def mesh_axes(mesh) -> Tuple[Tuple[str, ...], str]:
    """(data_axes, model_axis) for single-pod / multi-pod meshes."""
    names = tuple(mesh.axis_names)
    if names[-1] != "model":
        raise ValueError(f"expected trailing 'model' axis, got {names}")
    return names[:-1], "model"


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _axes_size(mesh, axes: Sequence[str]) -> int:
    return math.prod(mesh.shape[a] for a in axes)


def _param_rule(path: str, ndim: int, dp, mp) -> P:
    """Spec for one (unstacked) parameter leaf."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf in ("embed",):
        return P(mp, dp)                       # (V, D): vocab TP, d FSDP
    if leaf == "lm_head":
        return P(dp, mp)                       # (D, V)
    if leaf in ("wq", "wk", "wv", "w_gate", "w_in", "in_proj"):
        return P(dp, mp)                       # (D, out): out TP
    if leaf in ("wo", "w_out", "out_proj"):
        return P(mp, dp)                       # (in, D): in TP
    if leaf == "router":
        return P(dp, None)                     # (D, E): experts replicated
    if leaf in ("bq", "bk", "bv", "b_in"):
        return P(mp)
    if leaf in ("bo", "b_out"):
        return P(None)
    if leaf == "conv_w":
        return P(None, mp)                     # (K, C)
    if leaf == "conv_b":
        return P(mp)
    if leaf == "norm_scale":
        return P(mp)                           # (d_inner,) SSD gated norm
    if leaf in ("dt_bias", "a_log", "d_skip"):
        return P(None)                         # tiny per-head vectors
    if leaf in ("scale", "bias"):
        return P(None)                         # layer norms
    return P(*([None] * ndim))


def _moe_rule(path: str, ndim: int, dp, mp, mode: str = "2d") -> Optional[P]:
    """Expert-stacked leaves: (E, D, F) / (E, F, D).

    mode "2d": D over the data axes, F over model.  mode "f_allaxes": F
    over ALL axes, D unsharded."""
    leaf = path.rsplit("/", 1)[-1]
    if "moe" not in path:
        return None
    axes_all = (dp if isinstance(dp, tuple) else (dp,)) + (mp,)
    if leaf in ("w_gate", "w_in"):
        return P(None, None, axes_all) if mode == "f_allaxes" else P(None, dp, mp)
    if leaf == "w_out":
        return P(None, axes_all, None) if mode == "f_allaxes" else P(None, mp, dp)
    return None


def param_pspec(path: str, ndim: int, dp, mp, stacked: bool,
                moe_mode: str = "2d") -> P:
    """Spec for a leaf; ``stacked`` leaves get a leading None (block dim)."""
    inner_ndim = ndim - 1 if stacked else ndim
    rule = _moe_rule(path, inner_ndim, dp, mp, moe_mode) \
        or _param_rule(path, inner_ndim, dp, mp)
    parts = list(rule) + [None] * (inner_ndim - len(rule))
    if stacked:
        parts = [None] + parts
    return P(*parts)


def sanitize_spec(spec: Sequence, shape: Tuple[int, ...], mesh) -> P:
    """Drop mesh axes from dims they do not divide.  Axes are dropped from
    the right of a dim's axis tuple until the remaining product divides
    the dim."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, ax in zip(shape, parts):
        if ax is None:
            out.append(None)
            continue
        axes = list(_entry_axes(ax))
        while axes:
            if dim % _axes_size(mesh, axes) == 0:
                break
            axes.pop()
        out.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
    return P(*out)


def sanitize_specs(specs: PyTree, shapes: PyTree, mesh) -> PyTree:
    leaf_of = dict(tr.flatten(shapes))
    return tr.unflatten((path, sanitize_spec(s, tuple(leaf_of[path].shape), mesh))
                        for path, s in tr.flatten(specs))


def param_specs(cfg: ModelConfig, params_shape: PyTree, mesh) -> PyTree:
    """Spec tree matching the param tree (meta tensors suffice)."""
    dp_axes, mp = mesh_axes(mesh)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]

    def spec_of(path, leaf):
        ps = _path_str(path)
        shape = tuple(leaf.shape)
        leafname = ps.rsplit("/", 1)[-1]
        # vocab-carrying leaves: preference chain (odd vocab sizes fall back
        # to sharding d_model on the model axis rather than dropping TP)
        if leafname == "embed":
            chain = (P(mp, dp), P(None, mp), P(None, dp))
        elif leafname == "lm_head":
            chain = (P(dp, mp), P(mp, None), P(dp, None))
        else:
            chain = None
        if chain is not None:
            for cand in chain:
                if sanitize_spec(cand, shape, mesh) == cand:
                    return cand
            return sanitize_spec(chain[0], shape, mesh)
        stacked = ps.startswith("blocks") or ps.startswith("enc_blocks")
        return sanitize_spec(param_pspec(ps, len(shape), dp, mp, stacked,
                                         cfg.moe_weight_shard), shape, mesh)

    return tr.unflatten((path, spec_of(path, leaf))
                        for path, leaf in tr.flatten(params_shape))


def opt_state_specs(cfg: ModelConfig, opt_shape: PyTree, pspecs: PyTree,
                    mesh) -> PyTree:
    """Optimizer-state specs mirror the param specs (incl. Moment8 leaves:
    ``scale`` has the param's rank, its last dim / 128, so the same spec
    applies to both)."""
    def expand(moments):
        leaf_of = dict(tr.flatten(moments))
        out = []
        for path, ps in tr.flatten(pspecs):
            leaf = leaf_of[path]
            if isinstance(leaf, Moment8):
                out.append((path, Moment8(q=sanitize_spec(ps, tuple(leaf.q.shape), mesh),
                                          scale=sanitize_spec(ps, tuple(leaf.scale.shape),
                                                              mesh))))
            else:
                out.append((path, sanitize_spec(ps, tuple(leaf.shape), mesh)))
        return tr.unflatten(out)

    return {"m": expand(opt_shape["m"]), "v": expand(opt_shape["v"]), "step": P()}


def batch_specs(cfg: ModelConfig, mesh, with_embeds: bool) -> Dict[str, P]:
    dp_axes, _ = mesh_axes(mesh)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    tokens = P(dp, None)
    if not with_embeds:
        return {"tokens": tokens}
    return {"tokens": tokens, "embeds": P(dp, None, None)}


def cache_specs(cfg: ModelConfig, cache_shape: PyTree, mesh, batch: int) -> PyTree:
    """Decode-cache specs (stacked leading n_blocks dim on every leaf)."""
    dp_axes, mp = mesh_axes(mesh)
    dp = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    batch_sharded = batch >= _axes_size(mesh, dp_axes)

    def spec_of(leafname: str, ndim: int) -> P:
        if leafname in ("k", "v", "cross_k", "cross_v"):
            # (blocks, B, S, kv, hd)
            if batch_sharded:
                return P(None, dp, mp, None, None)
            return P(None, None, (*dp_axes, mp), None, None)
        if leafname == "ssm":
            # (blocks, B, H, N, P)
            if batch_sharded:
                return P(None, dp, mp, None, None)
            return P(None, None, mp, None, None)
        if leafname == "conv":
            # (blocks, B, K-1, C)
            if batch_sharded:
                return P(None, dp, None, mp)
            return P(None, None, None, mp)
        return P(*([None] * ndim))

    return tr.unflatten(
        (path, sanitize_spec(spec_of(path[-1], len(leaf.shape)), tuple(leaf.shape), mesh))
        for path, leaf in tr.flatten(cache_shape))


# --------------------------------------------------------------------------
# slices of the single-controller mesh
# --------------------------------------------------------------------------

def positions(mesh) -> List[Dict[str, int]]:
    """Each mesh position's coordinates, row-major over ``axis_names``
    (the order of ``mesh.devices``)."""
    out: List[Dict[str, int]] = [{}]
    for a in mesh.axis_names:
        out = [{**c, a: i} for c in out for i in range(mesh.shape[a])]
    return out


def local_shape(spec: Sequence, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    """The shape of the slice each position holds.  Every dim must divide
    by the product of its axes (a sanitized spec does), so every position
    holds the same shape."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, parts):
        n = _axes_size(mesh, _entry_axes(entry))
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {entry} ({n} positions)")
        out.append(dim // n)
    return tuple(out)


def _slices(spec: Sequence, shape: Sequence[int], mesh, coords: Dict[str, int]):
    """The index of position ``coords``'s slice of a tensor of ``shape``."""
    local = local_shape(spec, shape, mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    idx = []
    for n, entry in zip(local, parts):
        s = 0
        for a in _entry_axes(entry):
            s = s * mesh.shape[a] + coords[a]
        idx.append(slice(s * n, (s + 1) * n))
    return tuple(idx)


def shard(t: torch.Tensor, spec: Sequence, mesh) -> List[torch.Tensor]:
    """Each mesh position's slice of ``t``, a contiguous copy on that
    position's device (a position on ``meta`` costs no memory).  Positions
    the spec does not split ``t`` over hold copies of the same slice."""
    out = []
    for coords, device in zip(positions(mesh), mesh.devices):
        piece = t[_slices(spec, t.shape, mesh, coords)]
        out.append(torch.empty(piece.shape, dtype=t.dtype, device=device).copy_(piece))
    return out


def unshard(shards: Sequence[torch.Tensor], spec: Sequence, mesh) -> torch.Tensor:
    """The tensor whose :func:`shard` gives ``shards``, on the mesh's first
    device.  Each slice is read from the first position that holds it."""
    device = mesh.first_device
    local = tuple(shards[0].shape)
    used = {a for entry in spec for a in _entry_axes(entry)}
    full = tuple(n * _axes_size(mesh, _entry_axes(e)) for n, e in
                 zip(local, list(spec) + [None] * (len(local) - len(spec))))
    out = torch.empty(full, dtype=shards[0].dtype, device=device)
    for coords, piece in zip(positions(mesh), shards):
        if all(coords[a] == 0 for a in mesh.axis_names if a not in used):
            out[_slices(spec, full, mesh, coords)] = piece.to(device)
    return out


def local_bytes(specs: PyTree, tree: PyTree, mesh) -> int:
    """Bytes one position holds of ``tree`` under ``specs``.  A NamedTuple
    leaf has a NamedTuple of specs (``Moment8``), or one spec for each of
    its tensors."""
    spec_of = dict(tr.flatten(specs))
    total = 0
    for path, leaf in tr.flatten(tree):
        spec = spec_of[path]
        if isinstance(leaf, torch.Tensor):
            pairs = ((spec, leaf),)
        elif isinstance(spec, P):
            pairs = ((spec, t) for t in leaf)
        else:
            pairs = zip(spec, leaf)
        for s, t in pairs:
            total += math.prod(local_shape(s, t.shape, mesh)) * t.element_size()
    return total
