"""Shared neural-net layers (pure functions over param dicts), PyTorch port
of ``repro/models/layers.py``.

Init draws from a ``torch.Generator`` (on the generator's device, then moved
to ``device``); it cannot reproduce the reference's ``jax.random`` draw, so
weights that must match the reference cross as arrays
(``repro_torch.interop.model_params_from_numpy``).  The forward functions
keep the reference's numerics: norms, RoPE and softcaps in float32, the
tanh approximation of GELU (``jax.nn.gelu(approximate=True)``).
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------

def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal draws; on the meta device, shapes only (no draw)."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    return torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                       device=generator.device).to(device)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               device, lead=()) -> torch.Tensor:
    """Normal / sqrt(d_in) of shape ``lead + (d_in, d_out)`` (``lead`` is the
    stacked-block axis)."""
    scale = 1.0 / math.sqrt(d_in)
    return (_normal(generator, (*lead, d_in, d_out), device) * scale).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    return (_normal(generator, (vocab, d), device) * 0.02).to(dtype)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def make_norm_params(cfg: ModelConfig, d: int, device, lead=()) -> Dict[str, torch.Tensor]:
    dt = cfg.activation_dtype
    p = {"scale": torch.ones((*lead, d), dtype=dt, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=dt, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, n_heads, head_dim]; positions: broadcastable to [..., S]."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)              # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs    # [..., S, hd/2]
    cos = torch.cos(angles)[..., None, :]                      # [..., S, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP variants
# --------------------------------------------------------------------------

def make_mlp_params(cfg: ModelConfig, generator: torch.Generator, d: int, f: int,
                    device, lead=()) -> Dict[str, torch.Tensor]:
    dt = cfg.activation_dtype
    p: Dict[str, torch.Tensor] = {}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(generator, d, f, dt, device, lead)
    p["w_in"] = dense_init(generator, d, f, dt, device, lead)
    p["w_out"] = dense_init(generator, f, d, dt, device, lead)
    if cfg.use_bias:
        p["b_in"] = torch.zeros((*lead, f), dtype=dt, device=device)
        p["b_out"] = torch.zeros((*lead, d), dtype=dt, device=device)
    return p


def apply_mlp(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_in"])
    elif cfg.mlp_type == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_in"])
    else:
        h = x @ p["w_in"]
        if "b_in" in p:
            h = h + p["b_in"]
        h = F.gelu(h, approximate="tanh")
    y = h @ p["w_out"]
    if "b_out" in p:
        y = y + p["b_out"]
    return y


# --------------------------------------------------------------------------
# misc
# --------------------------------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return (torch.tanh(x / cap) * cap).to(x.dtype)
