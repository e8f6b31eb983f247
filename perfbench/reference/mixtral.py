"""A Mixtral decoder (arXiv:2401.04088, §2), its forward pass in plain
float32 PyTorch, with TF32 off.

    x_0      = E[t]
    h_l      = x_l + Attn_l(RMSNorm(x_l))
    x_{l+1}  = h_l + sum_{i in top-k(h W_r)} softmax_i(top-k logits) * SwiGLU_i(RMSNorm(h_l))
    logits   = RMSNorm(x_L) W_head

Attention is causal, grouped-query (each key/value head shared by
``n_heads / n_kv_heads`` query heads), with rotary embeddings (rotate-half,
base ``rope_theta``) on queries and keys, softmax(q k^T / sqrt(head_dim)).
SwiGLU_i(x) = (silu(x W_gate,i) * (x W_in,i)) W_out,i; RMSNorm(x) =
x / sqrt(mean(x^2) + eps) * g.  Departures from the paper: none at the
sizes the benchmark runs (its sliding window of 4,096 never binds below
4,096 positions, and Mixtral-8x22B's published config has none).

The weights are the tree the benchmark made (``systems/model_serve.py``),
read, never written: each layer's bf16 weights are cast to float32 for that
layer alone (an expert at a time), so the pass fits beside the served
model.  Nothing here imports the program.

:class:`Variant` gives the controls: float8 (e4m3, one scale a tensor)
operands in every matrix product of a linear layer; ``top_k`` experts in
place of the configuration's; positions from ``short_from`` on attend to
the cache one position short (not to themselves).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Variant:
    matmul: str = "float32"            # "float32" | "e4m3"
    top_k: Optional[int] = None        # None: the configuration's
    short_from: Optional[int] = None   # first position that does not see itself


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32, not TF32, inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor, back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, v: Variant) -> torch.Tensor:
    w = w.to(torch.float32)
    if v.matmul == "e4m3":
        x, w = e4m3(x), e4m3(w)
    return x @ w


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.to(torch.float32)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, heads, hd] rotated by its position (rotate-half)."""
    s, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    a, b = x[..., : hd // 2], x[..., hd // 2 :]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], dim=-1)


def _attention(cfg: dict, p: Dict[str, torch.Tensor], l: int, x: torch.Tensor,
               v: Variant) -> torch.Tensor:
    """One sequence's causal attention, x [S, D] -> [S, D]."""
    s = x.shape[0]
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_model"] // cfg["n_heads"]
    q = _rope(_mm(x, p["wq"][l], v).reshape(s, h, hd), cfg["rope_theta"])
    k = _rope(_mm(x, p["wk"][l], v).reshape(s, kv, hd), cfg["rope_theta"])
    val = _mm(x, p["wv"][l], v).reshape(s, kv, hd)
    k = k.repeat_interleave(h // kv, dim=1)
    val = val.repeat_interleave(h // kv, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    pos = torch.arange(s, device=x.device)
    allowed = pos[None, :] <= pos[:, None]
    if v.short_from is not None:
        allowed &= ~((pos[None, :] == pos[:, None]) & (pos[:, None] >= v.short_from))
    scores = scores.masked_fill(~allowed, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), val)
    return _mm(out.reshape(s, h * hd), p["wo"][l], v)


def _moe(cfg: dict, p: Dict[str, torch.Tensor], l: int, x: torch.Tensor,
         v: Variant) -> torch.Tensor:
    """The sparse expert layer on tokens x [N, D]."""
    k = v.top_k or cfg["top_k"]
    router = x @ p["router"][l].to(torch.float32)
    top, experts = torch.topk(router, k, dim=-1)
    weight = torch.softmax(top, dim=-1)
    out = torch.zeros_like(x)
    for e in range(cfg["n_experts"]):
        tok, slot = torch.nonzero(experts == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        hidden = F.silu(_mm(xe, p["w_gate"][l, e], v)) * _mm(xe, p["w_in"][l, e], v)
        out.index_add_(0, tok, _mm(hidden, p["w_out"][l, e], v) * weight[tok, slot, None])
    return out


def logits(cfg: dict, weights: dict, tokens: torch.Tensor, first: int = 0,
           variant: Variant = Variant()) -> torch.Tensor:
    """float32 logits [B, S - first, vocab] of every position from ``first``
    on, for token rows ``tokens`` int [B, S]; layer by layer over the
    rows, each row's attention on its own."""
    eps = cfg["norm_eps"]
    blocks = weights["blocks"]["layer_0"]
    attn, moe = blocks["attn"], blocks["moe"]
    with no_tf32(), torch.no_grad():
        x = weights["embed"][tokens.long()].to(torch.float32)              # [B, S, D]
        b, s, d = x.shape
        for l in range(cfg["n_layers"]):
            xn = _rms(x, blocks["norm1"]["scale"][l], eps)
            x = x + torch.stack([_attention(cfg, attn, l, xn[i], variant) for i in range(b)])
            xn = _rms(x, blocks["norm2"]["scale"][l], eps).reshape(b * s, d)
            x = x + _moe(cfg, moe, l, xn, variant).reshape(b, s, d)
        xn = _rms(x[:, first:], weights["final_norm"]["scale"], eps)
        return _mm(xn, weights["lm_head"], variant)
