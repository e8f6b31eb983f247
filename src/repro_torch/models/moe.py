"""Mixture-of-Experts FFN: top-k routing with capacity-based gather
dispatch, PyTorch port of ``repro/models/moe.py``.

Dispatch is sort-based (a stable argsort by expert id -> capacity buckets ->
gather), so expert compute is one batched matmul of shape [E, C, *] with
C = T * top_k * capacity_factor / E.  Overflowing tokens are dropped and
their combine weight is zero.  Up to T * k = 4,096 routed slots the
dispatch is dropless (C = T * k).

The order of ties is the reference's: top-k by a stable descending sort
(``jax.lax.top_k`` puts the lower expert first on ties; ``torch.topk``
promises no order), the dispatch order by a stable argsort, each slot's
place in its bucket by ``searchsorted(side="left")``.  The gather into the
buckets writes one value a kept slot (dropped slots add zeros), so it is
exact on any device; the combine adds each token's k weighted outputs with
``index_add_``, which runs in slot order on the CPU and by float atomics in
any order on the card.

``cfg.moe_dispatch`` picks the dispatch under a mesh context
(``models/shard_ctx.activation_sharding``), as in the reference:

  * ``global`` -- one capacity over all T tokens;
  * ``local`` -- per-group capacity (:func:`_grouped_dispatch`), one group
    per data position (:func:`_dispatch_groups`); the groups run one after
    another on the tokens' device;
  * ``ep_shardmap`` -- :func:`_shardmap_dispatch`: each (data, model)
    position of the single-controller mesh routes its data shard's tokens
    on its own device, computes its F-slice of every expert, and the
    partial outputs are summed over ``model`` in position order.

Outside a context every mode takes the global dispatch, as the reference
does.  ``apply_moe(groups=G)`` runs the per-group dispatch with G given,
in or out of a context.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.distributed import psum
from repro_torch.models import shard_ctx
from repro_torch.models.layers import _normal, dense_init


def make_moe_params(cfg: ModelConfig, generator: torch.Generator, device,
                    lead=()) -> Dict[str, torch.Tensor]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.activation_dtype
    p = {
        "router": dense_init(generator, d, e, torch.float32, device, lead),
        "w_in": (_normal(generator, (*lead, e, d, f), device) / math.sqrt(d)).to(dt),
        "w_out": (_normal(generator, (*lead, e, f, d), device) / math.sqrt(f)).to(dt),
    }
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = (_normal(generator, (*lead, e, d, f), device) / math.sqrt(d)).to(dt)
    return p


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots an expert holds for ``t`` tokens: every routed slot while
    ``t * top_k <= 4096`` (decode steps, small batches), else the capacity
    rule, rounded half to even as Python's ``round``."""
    k = cfg.top_k
    if t * k <= 4096:
        return t * k
    return int(max(1, round(t * k * cfg.capacity_factor / cfg.n_experts)))


def _route(cfg: ModelConfig, p, xt: torch.Tensor):
    """Router probabilities [T, E] and the top-k (weights, experts) [T, k],
    ties to the lower expert, the weights renormalised."""
    gates = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    weights, experts = vals[:, : cfg.top_k], idx[:, : cfg.top_k]
    return gates, weights / torch.sum(weights, dim=-1, keepdim=True), experts


def _experts(cfg: ModelConfig, xe: torch.Tensor, w_in, w_out, w_gate) -> torch.Tensor:
    """The expert FFN on the buckets: [E, C, D] -> [E, C, D]."""
    if w_gate is not None:
        g = torch.bmm(xe, w_gate)
        act = F.silu(g) if cfg.mlp_type == "swiglu" else F.gelu(g, approximate="tanh")
        h = act * torch.bmm(xe, w_in)
    else:
        h = F.gelu(torch.bmm(xe, w_in), approximate="tanh")
    return torch.bmm(h, w_out)


def _dispatch(cfg: ModelConfig, p, xt: torch.Tensor, experts: torch.Tensor,
              weights: torch.Tensor, cap: int):
    """Capacity-bucketed dispatch of one group's T tokens -> (out [T, D],
    kept [T*k] bool)."""
    t, d = xt.shape
    e, k = cfg.n_experts, cfg.top_k
    flat_expert = experts.reshape(-1)                                   # [T*k]
    order = torch.argsort(flat_expert, stable=True)
    sorted_expert = flat_expert[order]
    # position of each routed slot within its expert's bucket
    slot = torch.arange(t * k, device=xt.device) - torch.searchsorted(
        sorted_expert, sorted_expert, side="left")
    keep = slot < cap
    token_of = order // k                                               # [T*k]
    dest = torch.where(keep, sorted_expert * cap + slot, torch.zeros_like(slot))
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    upd = torch.where(keep[:, None], xt[token_of], zero)
    buf = torch.zeros((e * cap, d), dtype=xt.dtype, device=xt.device)
    buf.index_add_(0, dest, upd)
    ye = _experts(cfg, buf.reshape(e, cap, d), p["w_in"], p["w_out"],
                  p.get("w_gate")).reshape(e * cap, d)
    gathered = torch.where(keep[:, None], ye[dest], zero)
    wcomb = (weights.reshape(-1)[order] * keep).to(xt.dtype)
    out = torch.zeros((t, d), dtype=xt.dtype, device=xt.device)
    out.index_add_(0, token_of, gathered * wcomb[:, None])
    return out, keep


def _lb_loss(cfg: ModelConfig, gates: torch.Tensor, experts: torch.Tensor) -> torch.Tensor:
    me = torch.mean(gates, dim=0)                                        # [E]
    ce = torch.mean(F.one_hot(experts[:, 0], cfg.n_experts).to(torch.float32), dim=0)
    return cfg.n_experts * torch.sum(me * ce)


def _dispatch_groups(cfg: ModelConfig, t: int) -> int:
    """Dispatch groups for ``moe_dispatch="local"``: one per data position
    of the active mesh (the product of its non-``model`` axes), halved
    until it divides ``t``; 1 without a context or in another mode."""
    if cfg.moe_dispatch != "local":
        return 1
    mesh = shard_ctx.current_mesh()
    if mesh is None:
        return 1
    g = math.prod(n for a, n in mesh.shape.items() if a != "model")
    while g > 1 and t % g:
        g //= 2
    return max(1, g)


def apply_moe(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,            # [B, S, D]
    groups: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The MoE FFN -> (out [B, S, D], aux): ``lb_loss``, ``dropped_frac``
    and ``expert_choice`` ([T, k]; ``(1, k)`` zeros from ``ep_shardmap``).
    ``groups`` overrides the group count of :func:`_dispatch_groups`."""
    b, s, d = x.shape
    t = b * s
    if groups is None:
        if cfg.moe_dispatch == "ep_shardmap" and shard_ctx.current_mesh() is not None:
            return _shardmap_dispatch(cfg, p, x)
        groups = _dispatch_groups(cfg, t)
    xt = x.reshape(t, d)
    gates, weights, experts = _route(cfg, p, xt)
    if groups > 1:
        out, aux = _grouped_dispatch(
            cfg, p, xt.reshape(groups, t // groups, d),
            experts.reshape(groups, t // groups, cfg.top_k),
            weights.reshape(groups, t // groups, cfg.top_k))
    else:
        out, keep = _dispatch(cfg, p, xt, experts, weights, capacity(cfg, t))
        aux = {"dropped_frac": 1.0 - torch.mean(keep.to(torch.float32))}
    aux["lb_loss"] = _lb_loss(cfg, gates, experts)
    aux["expert_choice"] = experts
    return out.reshape(b, s, d), aux


def _grouped_dispatch(cfg: ModelConfig, p, xg, eg, wg):
    """Per-group capacity dispatch.  xg: [G, Tl, D], eg/wg: [G, Tl, k];
    each group's capacity is computed from its own Tl tokens."""
    g_, tl, d = xg.shape
    cap = capacity(cfg, tl)
    outs, kept = [], []
    for g in range(g_):
        out, keep = _dispatch(cfg, p, xg[g], eg[g], wg[g], cap)
        outs.append(out)
        kept.append(torch.mean(keep.to(torch.float32)))
    return (torch.cat(outs, dim=0),
            {"dropped_frac": 1.0 - torch.mean(torch.stack(kept))})


# --------------------------------------------------------------------------
# expert dispatch on the single-controller mesh (moe_dispatch="ep_shardmap")
# --------------------------------------------------------------------------

def _shardmap_dispatch(cfg: ModelConfig, p, x: torch.Tensor):
    """The reference's ``shard_map`` expert compute on the port's mesh.

    The batch is split over the data positions (row-major over the data
    axes).  Each (data, model) position, on its own device, routes its
    data shard's tokens with the per-shard capacity, dispatches them,
    computes its F-slice of every expert (``w_gate``/``w_in`` ``[E, D,
    F/M]``, ``w_out`` ``[E, F/M, D]``, views of the whole weights) and
    combines.  The model positions' partial outputs are summed in position
    order (``core/distributed.psum``, the reference's ``psum`` over
    ``model``) and the data shards concatenated in order on the mesh's
    first device.  ``lb_loss`` and ``dropped_frac`` are the mean over the
    data shards of each shard's value (the reference's ``pmean``)."""
    mesh = shard_ctx.current_mesh()
    b, s, d = x.shape
    n_model = mesh.shape["model"]
    n_data = mesh.size // n_model
    f = p["w_in"].shape[-1]
    if b % n_data or f % n_model:
        raise ValueError(f"batch {b} over {n_data} data positions, d_ff {f} over "
                         f"{n_model} model positions: both must divide")
    bl, fl = b // n_data, f // n_model
    tl = bl * s
    cap = capacity(cfg, tl)
    partials = [[None] * n_model for _ in range(n_data)]
    lb, kept = [None] * n_data, [None] * n_data
    # positions are row-major with "model" last: position i is data shard
    # i // n_model, model column i % n_model
    for pos, device in enumerate(mesh.devices):
        di, mi = divmod(pos, n_model)
        fs = slice(mi * fl, (mi + 1) * fl)
        pw = {"router": p["router"].to(device),
              "w_in": p["w_in"][:, :, fs].to(device),
              "w_out": p["w_out"][:, fs, :].to(device)}
        if "w_gate" in p:
            pw["w_gate"] = p["w_gate"][:, :, fs].to(device)
        xt = x[di * bl : (di + 1) * bl].to(device).reshape(tl, d)
        gates, weights, experts = _route(cfg, pw, xt)
        partials[di][mi], keep = _dispatch(cfg, pw, xt, experts, weights, cap)
        if mi == 0:
            lb[di] = _lb_loss(cfg, gates, experts)
            kept[di] = torch.mean(keep.to(torch.float32))
    first = mesh.first_device
    out = torch.cat([psum(row, first) for row in partials], dim=0)
    aux = {"lb_loss": torch.mean(torch.stack([v.to(first) for v in lb])),
           "dropped_frac": torch.mean(torch.stack([1.0 - v.to(first) for v in kept])),
           "expert_choice": torch.zeros((1, cfg.top_k), dtype=torch.int32, device=first)}
    return out.reshape(b, s, d), aux
