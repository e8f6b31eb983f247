"""GQA/MQA attention: full, sliding-window, blockwise (long sequences),
cross attention and single-token decode against a KV cache, PyTorch port
of ``repro/models/attention.py``.

The reference computes attention with plain jnp einsums and a softmax (no
Pallas kernel), so the port does the same with ``torch.einsum``: logits in
float32, masked with ``-1e30``, softmax in float32 and cast back to the
activation dtype.  Blockwise attention chunks the query axis (a Python loop
in place of ``lax.scan``) so the [B, H, S, S] logits never exist at once;
it is numerically identical to the dense path and switches on above
``cfg.attn_chunk_threshold``.

Decode writes the new token's K/V into the cache *in place* (the
reference returns an updated copy): a cache tensor is the one the caller
passed, changed.  A position at or past the cache's length writes its last
slot, as ``lax.dynamic_update_slice`` clamps the reference's write.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init


def make_attn_params(cfg: ModelConfig, generator: torch.Generator, device,
                     lead=()) -> Dict[str, torch.Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = cfg.activation_dtype
    p = {
        "wq": dense_init(generator, d, cfg.n_heads * hd, dt, device, lead),
        "wk": dense_init(generator, d, cfg.n_kv_heads * hd, dt, device, lead),
        "wv": dense_init(generator, d, cfg.n_kv_heads * hd, dt, device, lead),
        "wo": dense_init(generator, cfg.n_heads * hd, d, dt, device, lead),
    }
    if cfg.use_bias:
        for name, n in (("bq", cfg.n_heads * hd), ("bk", cfg.n_kv_heads * hd),
                        ("bv", cfg.n_kv_heads * hd), ("bo", d)):
            p[name] = torch.zeros((*lead, n), dtype=dt, device=device)
    return p


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor,
                 kv_x: Optional[torch.Tensor] = None):
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    kv_src = x if kv_x is None else kv_x
    q = x @ p["wq"]
    k = kv_src @ p["wk"]
    v = kv_src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, x.shape[1], cfg.n_heads, hd),
            k.reshape(b, kv_src.shape[1], cfg.n_kv_heads, hd),
            v.reshape(b, kv_src.shape[1], cfg.n_kv_heads, hd))


def _expand_kv(cfg: ModelConfig, k: torch.Tensor) -> torch.Tensor:
    """[B, S, n_kv, hd] -> [B, S, n_heads, hd] by repeating each kv head."""
    rep = cfg.n_heads // cfg.n_kv_heads
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def _attend(cfg: ModelConfig, q, k, v, mask) -> torch.Tensor:
    """q: [B,Sq,H,hd], k/v: [B,Sk,H,hd], mask: [B or 1, 1, Sq, Sk] bool."""
    scale = 1.0 / math.sqrt(cfg.resolved_head_dim)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    if cfg.attn_softcap:
        logits = torch.tanh(logits / cfg.attn_softcap) * cfg.attn_softcap
    logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=torch.float32,
                                                    device=logits.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _causal_mask(sq: int, sk: int, q_offset: int, window: int,
                 device=None) -> torch.Tensor:
    """bool[1, 1, Sq, Sk]: causal (+ sliding window if window > 0)."""
    qpos = q_offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m = m & (kpos > qpos - window)
    return m[None, None]


def self_attention(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,             # [B, S, D]
    positions: torch.Tensor,     # [B, S] or [S]
    window: int,
    causal: bool = True,
) -> torch.Tensor:
    return _self_attention_kv(cfg, p, x, positions, window, causal)[0]


def _self_attention_kv(cfg: ModelConfig, p, x, positions, window: int,
                       causal: bool = True):
    """Self attention -> (out [B, S, D], the rotated K [B, S, n_kv, hd],
    V): the prompt's K/V are what ``prefill`` caches."""
    b, s, _ = x.shape
    q, k_heads, v_heads = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k_heads = apply_rope(k_heads, positions, cfg.rope_theta)
    k = _expand_kv(cfg, k_heads)
    v = _expand_kv(cfg, v_heads)

    if causal and s > cfg.attn_chunk_threshold:
        out = _blockwise_causal(cfg, q, k, v, window)
    else:
        if causal:
            mask = _causal_mask(s, s, 0, window, x.device)
        else:
            mask = torch.ones((1, 1, s, s), dtype=torch.bool, device=x.device)
        out = _attend(cfg, q, k, v, mask)
    out = out.reshape(b, s, -1) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out, k_heads, v_heads


def _blockwise_causal(cfg: ModelConfig, q, k, v, window: int) -> torch.Tensor:
    """Query-chunked causal attention (flash-style memory profile)."""
    b, s, h, hd = q.shape
    cq = min(cfg.attn_chunk, s)
    if s % cq:
        raise ValueError(f"seq {s} % chunk {cq} != 0")
    chunks = []
    for ci in range(s // cq):
        mask = _causal_mask(cq, s, ci * cq, window, q.device)      # [1,1,Cq,S]
        chunks.append(_attend(cfg, q[:, ci * cq : (ci + 1) * cq], k, v, mask))
    return torch.cat(chunks, dim=1)


def cross_attention(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,             # [B, Sq, D] decoder states
    enc: torch.Tensor,           # [B, Sk, D] encoder output
) -> torch.Tensor:
    q, k, v = _project_qkv(cfg, p, x, kv_x=enc)
    return _cross_attend(cfg, p, q, k, v)


def _cross_attend(cfg: ModelConfig, p, q, k, v) -> torch.Tensor:
    """Unmasked attention of q [B, Sq, H, hd] over the encoder's K/V
    [B, Sk, n_kv, hd], through the out projection."""
    b, sq = q.shape[:2]
    k = _expand_kv(cfg, k)
    v = _expand_kv(cfg, v)
    mask = torch.ones((1, 1, sq, k.shape[1]), dtype=torch.bool, device=q.device)
    out = _attend(cfg, q, k, v, mask).reshape(b, sq, -1) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


# --------------------------------------------------------------------------
# decode (single new token against a KV cache)
# --------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device, lead=()) -> Dict[str, torch.Tensor]:
    """Zero K/V of shape ``lead + (batch, max_len, n_kv_heads, head_dim)``;
    ``lead`` is the stacked-block axis, each block its own memory."""
    shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = cfg.activation_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_self_attention(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    x: torch.Tensor,               # [B, 1, D] the new token's hidden state
    pos: Union[int, torch.Tensor],  # position of the new token (whole batch)
    window: int,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token's attention; writes its K/V into ``cache`` in place and
    returns ``(out [B, 1, D], cache)``."""
    b = x.shape[0]
    pos = int(pos)
    q, k_new, v_new = _project_qkv(cfg, p, x)
    posb = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)
    _scatter_time(cache["k"], k_new, pos)
    _scatter_time(cache["v"], v_new, pos)
    k = _expand_kv(cfg, cache["k"])
    v = _expand_kv(cfg, cache["v"])
    kpos = torch.arange(k.shape[1], device=x.device)[None, None, None, :]
    mask = kpos <= pos
    if window:
        mask = mask & (kpos > pos - window)
    out = _attend(cfg, q, k, v, mask).reshape(b, 1, -1) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out, cache


def _scatter_time(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """Write the [B, 1, ...] slice at time ``pos`` in place.  As
    ``lax.dynamic_update_slice`` places it: a negative ``pos`` counts from
    the end, and the start is then clamped into the cache."""
    t = int(pos) + (cache.shape[1] if int(pos) < 0 else 0)
    t = min(max(t, 0), cache.shape[1] - 1)
    cache[:, t : t + 1] = new.to(cache.dtype)
