"""Mamba2 (SSD, state-space duality) mixer, PyTorch port of
``repro/models/ssm.py``.

The sequence is processed in chunks of Q tokens, a Python loop over the
chunks (in place of ``lax.scan``) carrying the inter-chunk SSM state H in
[B, heads, N, P]:

  * intra-chunk: the quadratic "attention-like" branch -- the masked decay
    matrix L composed with C.B^T;
  * inter-chunk: the linear recurrence H' = decay * H + B^T.(dt*x).

Exponentials and cumulative sums run in float32, and so do the
contractions.  The decay is masked *before* ``exp``: above the diagonal the
difference is positive and ``exp`` overflows, and an ``inf`` in the branch
``where`` drops still makes the backward pass NaN.  A tail shorter than a
chunk is padded with ``dt = 0`` (no decay, no contribution): exact.

Decode is the O(1) recurrence: a conv ring of the last ``ssm_conv - 1``
inputs and the per-token state update.  It writes both into the cache in
place (the reference returns updated copies).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _normal, dense_init


def make_ssm_params(cfg: ModelConfig, generator: torch.Generator, device,
                    lead=()) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    din = cfg.ssm_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    conv_ch = din + 2 * n                      # conv over [x, B, C]
    dt = cfg.activation_dtype
    a_log = torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32))
    return {
        # in_proj -> [z (din), x (din), B (n), C (n), dt (h)]
        "in_proj": dense_init(generator, d, 2 * din + 2 * n + h, dt, device, lead),
        "conv_w": (_normal(generator, (*lead, cfg.ssm_conv, conv_ch), device)
                   * 0.1).to(dt),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dt, device=device),
        "dt_bias": torch.zeros((*lead, h), dtype=torch.float32, device=device),
        "a_log": a_log.to(device).expand(*lead, h).contiguous(),
        "d_skip": torch.ones((*lead, h), dtype=torch.float32, device=device),
        "norm_scale": torch.ones((*lead, din), dtype=dt, device=device),
        "out_proj": dense_init(generator, din, d, dt, device, lead),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    din, n = cfg.ssm_inner, cfg.ssm_state
    z = proj[..., :din]
    x = proj[..., din : 2 * din]
    bmat = proj[..., 2 * din : 2 * din + n]
    cmat = proj[..., 2 * din + n : 2 * din + 2 * n]
    dt_raw = proj[..., 2 * din + 2 * n :]
    return z, x, bmat, cmat, dt_raw


def _causal_conv(p: Dict[str, torch.Tensor], u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width K: u [B, S, C] -> [B, S, C]."""
    k = p["conv_w"].shape[0]
    pad = F.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i : i + u.shape[1], :] * p["conv_w"][i]
    return out + p["conv_b"]


def _ssd_chunk_scan(cfg: ModelConfig, x, dtv, bmat, cmat, a, d_skip, h0):
    """Chunked SSD.  x:[B,S,H,P] dtv:[B,S,H] bmat/cmat:[B,S,N] a:[H].

    Returns (y [B,S,H,P], h_final [B,H,N,P])."""
    s = x.shape[1]
    q = min(cfg.ssm_chunk, s)
    s_orig = s
    if s % q:
        pad = q - s % q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtv = F.pad(dtv, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, pad))
        s = s + pad
    f32 = torch.float32
    mask = (torch.arange(q, device=x.device)[:, None]
            >= torch.arange(q, device=x.device)[None, :])[None, :, :, None]
    zero = torch.zeros((), dtype=f32, device=x.device)
    hstate = h0
    ys = []
    for c in range(s // q):
        sl = slice(c * q, (c + 1) * q)
        x_c = x[:, sl]                                        # [B,q,h,p]
        xf = x_c.to(f32)
        dt_c = dtv[:, sl].to(f32)                             # [B,q,h]
        b_c = bmat[:, sl].to(f32)                             # [B,q,n]
        c_c = cmat[:, sl].to(f32)
        da = dt_c * a                                         # [B,q,h] (a < 0)
        cs = torch.cumsum(da, dim=1)                          # [B,q,h]
        diff = cs[:, :, None, :] - cs[:, None, :, :]          # [B,i,j,h]
        ldecay = torch.where(mask, torch.exp(torch.where(mask, diff, zero)), zero)
        cb = torch.einsum("bin,bjn->bij", c_c, b_c)           # [B,i,j]
        m = cb[..., None] * ldecay                            # [B,i,j,h]
        y_diag = torch.einsum("bijh,bjh,bjhp->bihp", m, dt_c, xf)
        y_off = torch.einsum("bin,bhnp->bihp", c_c, hstate) * torch.exp(cs)[..., None]
        decay_to_end = torch.exp(cs[:, -1:, :] - cs)          # [B,j,h]
        s_c = torch.einsum("bjn,bjh,bjhp->bhnp", b_c, dt_c * decay_to_end, xf)
        hstate = torch.exp(cs[:, -1, :])[:, :, None, None] * hstate + s_c
        y = y_diag + y_off + d_skip[None, None, :, None] * xf
        ys.append(y.to(x_c.dtype))
    y = torch.cat(ys, dim=1)[:, :s_orig]
    return y, hstate


def _gated_out(cfg: ModelConfig, p, y: torch.Tensor, z: torch.Tensor,
               dtype) -> torch.Tensor:
    """Gated RMSNorm, then the out projection."""
    g = y * F.silu(z)
    ms = torch.mean(torch.square(g.to(torch.float32)), dim=-1, keepdim=True)
    g = (g.to(torch.float32) * torch.rsqrt(ms + cfg.norm_eps)).to(dtype)
    return (g * p["norm_scale"]) @ p["out_proj"]


def ssm_forward(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    u: torch.Tensor,                    # [B, S, D]
    h0: Optional[torch.Tensor] = None,  # [B, H, N, P] initial state
    return_state: bool = False,
):
    b, s, _ = u.shape
    din, n, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    pdim = cfg.ssm_head_dim

    proj = u @ p["in_proj"]
    z, x, bmat, cmat, dt_raw = _split_proj(cfg, proj)
    conv_in = torch.cat([x, bmat, cmat], dim=-1)
    conv_out = F.silu(_causal_conv(p, conv_in))
    x = conv_out[..., :din].reshape(b, s, h, pdim)
    bmat = conv_out[..., din : din + n]
    cmat = conv_out[..., din + n :]
    dtv = F.softplus(dt_raw.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    if h0 is None:
        h0 = torch.zeros((b, h, n, pdim), dtype=torch.float32, device=u.device)
    y, h_final = _ssd_chunk_scan(cfg, x, dtv, bmat, cmat, a, p["d_skip"], h0)
    out = _gated_out(cfg, p, y.reshape(b, s, din), z, u.dtype)
    if return_state:
        # conv ring state: the last (K-1) inputs to the conv, zeros before
        # the prompt's start when it is shorter
        k = cfg.ssm_conv
        tail = torch.cat(
            [torch.zeros((b, max(0, k - 1 - s), conv_in.shape[-1]),
                         dtype=conv_in.dtype, device=u.device),
             conv_in[:, max(0, s - (k - 1)):, :]], dim=1)
        return out, {"ssm": h_final, "conv": tail}
    return out


# --------------------------------------------------------------------------
# O(1) decode
# --------------------------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, batch: int, device,
                   lead=()) -> Dict[str, torch.Tensor]:
    din, n = cfg.ssm_inner, cfg.ssm_state
    return {
        "ssm": torch.zeros((*lead, batch, cfg.ssm_heads, n, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((*lead, batch, cfg.ssm_conv - 1, din + 2 * n),
                            dtype=cfg.activation_dtype, device=device),
    }


def ssm_decode(
    cfg: ModelConfig,
    p: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    u: torch.Tensor,                 # [B, 1, D]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token through the mixer; updates ``cache`` in place and returns
    ``(out [B, 1, D], cache)``."""
    b = u.shape[0]
    din, n, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    pdim = cfg.ssm_head_dim
    f32 = torch.float32

    proj = u[:, 0] @ p["in_proj"]                               # [B, *]
    z, x, bmat, cmat, dt_raw = _split_proj(cfg, proj)
    conv_in = torch.cat([x, bmat, cmat], dim=-1)                # [B, C]
    window = torch.cat([cache["conv"], conv_in[:, None, :].to(cache["conv"].dtype)],
                       dim=1)                                   # [B, K, C]
    conv_out = torch.einsum("bkc,kc->bc", window.to(f32), p["conv_w"].to(f32)) \
        + p["conv_b"].to(f32)
    conv_out = F.silu(conv_out).to(u.dtype)
    x = conv_out[:, :din].reshape(b, h, pdim)
    bmat = conv_out[:, din : din + n].to(f32)                   # [B, N]
    cmat = conv_out[:, din + n :].to(f32)
    dtv = F.softplus(dt_raw.to(f32) + p["dt_bias"])             # [B, H]
    a = -torch.exp(p["a_log"])

    decay = torch.exp(dtv * a)                                   # [B, H]
    hs = cache["ssm"] * decay[:, :, None, None] + \
        torch.einsum("bn,bh,bhp->bhnp", bmat, dtv, x.to(f32))
    y = torch.einsum("bn,bhnp->bhp", cmat, hs) + \
        p["d_skip"][None, :, None] * x.to(f32)
    out = _gated_out(cfg, p, y.reshape(b, din).to(u.dtype), z, u.dtype)[:, None, :]
    cache["ssm"].copy_(hs)
    cache["conv"].copy_(window[:, 1:, :])
    return out, cache

