"""GQA/MQA self-attention for training: full, sliding-window and blockwise
(long sequences), PyTorch port of ``repro/models/attention.py``.

The reference computes attention with plain jnp einsums and a softmax (no
Pallas kernel), so the port does the same with ``torch.einsum``: logits in
float32, masked with ``-1e30``, softmax in float32 and cast back to the
activation dtype.  Blockwise attention chunks the query axis (a Python loop
in place of ``lax.scan``) so the [B, H, S, S] logits never exist at once;
it is numerically identical to the dense path and switches on above
``cfg.attn_chunk_threshold``.

Cross attention and decode against a KV cache wait for the model-serving
slice (ROADMAP item 15).
"""
from __future__ import annotations

import math
from typing import Dict

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


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor):
    b, s = x.shape[0], x.shape[1]
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, cfg.n_heads, hd), k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


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
    b, s, _ = x.shape
    q, k, v = _project_qkv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k = _expand_kv(cfg, k)
    v = _expand_kv(cfg, v)

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
    return out


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
