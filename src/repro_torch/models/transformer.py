"""Layer-stack assembly: init, forward, the loss, prefill and decode for
every family, PyTorch port of ``repro/models/transformer.py``.

The parameters keep the reference's layout: the blocks' leaves are
*stacked*, one tensor of shape ``[n_blocks, ...]`` per leaf, and the stack
is a Python loop over the blocks (in place of ``lax.scan``), each block
holding ``cfg.block_period`` sublayers with a static kind per position
(attention or Mamba mixer, MLP or MoE, local or global window, cross
attention in an encoder-decoder's decoder).  The layout matters beyond the
forward: the gradient compressor plans and hashes each leaf by its shape
(rows = prod(shape[:-1])), so per-layer leaves would be sketched
differently.  Remat is not applied: the sizes this port trains fit
without it.

Decode caches are stacked the same way (``init_cache``: one tensor per
leaf, ``[n_blocks, B, ...]``, each block its own memory), and
``decode_step`` writes them *in place*: the cache it returns is the one it
was given, updated (the reference returns an updated copy).  ``prefill``
returns fresh caches padded to ``max_len``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    dense_init,
    embed_init,
    make_mlp_params,
    make_norm_params,
    softcap,
)

Params = Dict[str, Any]


# ==========================================================================
# init
# ==========================================================================

def _make_layer_params(cfg: ModelConfig, generator: torch.Generator, device,
                       i: int, lead, *, cross: bool = False) -> Params:
    """Params of sublayer position i of a block, stacked over ``lead``."""
    d = cfg.d_model
    p: Params = {"norm1": make_norm_params(cfg, d, device, lead)}
    if cfg.layer_kind(i) == "attn":
        p["attn"] = attn.make_attn_params(cfg, generator, device, lead)
    else:
        p["ssm"] = ssm_mod.make_ssm_params(cfg, generator, device, lead)
    if cross:
        p["norm_cross"] = make_norm_params(cfg, d, device, lead)
        p["cross"] = attn.make_attn_params(cfg, generator, device, lead)
    if cfg.d_ff and not cfg.parallel_block:
        p["norm2"] = make_norm_params(cfg, d, device, lead)
    if cfg.layer_is_moe(i):
        p["moe"] = moe_mod.make_moe_params(cfg, generator, device, lead)
    elif cfg.d_ff:
        p["mlp"] = make_mlp_params(cfg, generator, d, cfg.d_ff, device, lead)
    if cfg.post_block_norm:
        p["post_attn_norm"] = make_norm_params(cfg, d, device, lead)
        if cfg.d_ff:
            p["post_ff_norm"] = make_norm_params(cfg, d, device, lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Fresh parameters drawn from ``generator``, in the reference's tree.
    ``device="meta"`` gives their shapes and dtypes without memory (the
    port's ``jax.eval_shape`` of the reference's init)."""
    device = resolve_device(device)
    dt = cfg.activation_dtype
    lead = (cfg.n_blocks,)
    params: Params = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, device),
        "blocks": {f"layer_{i}": _make_layer_params(
            cfg, generator, device, i, lead, cross=bool(cfg.n_enc_layers))
            for i in range(cfg.block_period)},
        "final_norm": make_norm_params(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.padded_vocab,
                                       dt, device)
    if cfg.n_enc_layers:
        params["enc_blocks"] = {"layer_0": _make_layer_params(
            cfg, generator, device, 0, (cfg.n_enc_layers,))}
        params["enc_final_norm"] = make_norm_params(cfg, cfg.d_model, device)
    return params


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in tr.leaves(params))


# ==========================================================================
# forward building blocks
# ==========================================================================

def _unstack(tree: Params) -> List[Params]:
    """A tree stacked on a leading axis (blocks, or their caches) as one
    tree per entry of that axis (views, no copies)."""
    pairs = tr.flatten(tree)
    parts = [torch.unbind(leaf, 0) for _, leaf in pairs]
    return [tr.unflatten((path, part[n]) for (path, _), part in zip(pairs, parts))
            for n in range(len(parts[0]))]


def _apply_layer(cfg: ModelConfig, lp: Params, x: torch.Tensor, mix_fn,
                 cross_fn=None, aux: Optional[list] = None) -> torch.Tensor:
    """One sublayer around its mixer: ``mix_fn(normed x)`` (attention or
    Mamba, in its train, prefill or decode form), then cross attention
    (``cross_fn(normed x)``, where the layer has it) and the MLP or MoE.
    Each MoE's aux is appended to ``aux``."""
    h = apply_norm(cfg, lp["norm1"], x)
    mix = mix_fn(h)
    if cfg.post_block_norm:
        mix = apply_norm(cfg, lp["post_attn_norm"], mix)

    if cfg.parallel_block and "mlp" in lp:
        return x + mix + apply_mlp(cfg, lp["mlp"], h)
    x = x + mix

    if cross_fn is not None and "cross" in lp:
        x = x + cross_fn(apply_norm(cfg, lp["norm_cross"], x))

    if "moe" in lp or "mlp" in lp:
        h2 = apply_norm(cfg, lp["norm2"], x)
        if "moe" in lp:
            y, moe_aux = moe_mod.apply_moe(cfg, lp["moe"], h2)
            if aux is not None:
                aux.append(moe_aux)
        else:
            y = apply_mlp(cfg, lp["mlp"], h2)
        if cfg.post_block_norm:
            y = apply_norm(cfg, lp["post_ff_norm"], y)
        x = x + y
    return x


def _sum_aux(aux: list, device) -> Dict[str, torch.Tensor]:
    """The MoE layers' ``lb_loss`` and ``dropped_frac``, summed (0 without
    MoE layers)."""
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {k: sum((a[k] for a in aux), zero) for k in ("lb_loss", "dropped_frac")}


def _run_stack(cfg: ModelConfig, blocks: Params, x: torch.Tensor, mixers,
               cache: Optional[Params] = None, aux: Optional[list] = None) -> torch.Tensor:
    """Loop over the stacked blocks and each block's sublayers.
    ``mixers(i, lp, lc)`` gives sublayer i's ``(mix_fn, cross_fn)`` from its
    params ``lp`` and its cache ``lc`` (None without ``cache``)."""
    caches = _unstack(cache) if cache is not None else None
    for b, bp in enumerate(_unstack(blocks)):
        for i in range(len(bp)):
            lp = bp[f"layer_{i}"]
            lc = caches[b][f"layer_{i}"] if caches is not None else None
            mix_fn, cross_fn = mixers(i, lp, lc)
            x = _apply_layer(cfg, lp, x, mix_fn, cross_fn, aux)
    return x


def _stack_forward(cfg: ModelConfig, blocks: Params, x: torch.Tensor,
                   positions: torch.Tensor, enc: Optional[torch.Tensor] = None,
                   causal: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training forward of the stack; returns (hidden, summed aux)."""

    def mixers(i, lp, _):
        def attention(h):
            return attn.self_attention(cfg, lp["attn"], h, positions, cfg.layer_window(i),
                                       causal=causal)

        def mamba(h):
            return ssm_mod.ssm_forward(cfg, lp["ssm"], h)

        def cross(h):
            return attn.cross_attention(cfg, lp["cross"], h, enc)

        return (attention if cfg.layer_kind(i) == "attn" else mamba,
                cross if enc is not None else None)

    aux: list = []
    x = _run_stack(cfg, blocks, x, mixers, aux=aux)
    return x, _sum_aux(aux, x.device)


def _logits(cfg: ModelConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:
        # padded vocab rows exist only for TP divisibility: mask them out of
        # every softmax/argmax downstream
        pad_mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(pad_mask, logits,
                             torch.tensor(-1e30, dtype=logits.dtype, device=x.device))
    if cfg.logit_softcap:
        logits = softcap(logits.to(torch.float32), cfg.logit_softcap)
    return logits.to(torch.float32)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        scale = torch.sqrt(torch.tensor(float(cfg.d_model), dtype=torch.float32,
                                        device=x.device))
        x = x * scale.to(x.dtype)
    return x


def _encode(cfg: ModelConfig, params: Params, embeds: torch.Tensor) -> torch.Tensor:
    pos = torch.arange(embeds.shape[1], device=embeds.device)
    h, _ = _stack_forward(cfg, params["enc_blocks"], embeds, pos, causal=False)
    return apply_norm(cfg, params["enc_final_norm"], h)


def _inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor]):
    """(embedded decoder input, encoder output or None): an encoder-decoder
    encodes ``embeds``; any other model takes them as a prefix."""
    x = _embed(cfg, params, tokens)
    enc = None
    if cfg.n_enc_layers:
        enc = _encode(cfg, params, embeds.to(x.dtype))
    elif embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x, enc


# ==========================================================================
# public entry points
# ==========================================================================

def forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                  # int[B, S_text]
    embeds: Optional[torch.Tensor] = None,  # [B, F, D] frontend stub prefix
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training forward -> (logits [B, S_total, V] float32, aux)."""
    x, aux = hidden_forward(cfg, params, tokens, embeds=embeds)
    return _logits(cfg, params, x), aux


def hidden_forward(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    embeds: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward up to the final norm (no unembedding)."""
    x, enc = _inputs(cfg, params, tokens, embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _stack_forward(cfg, params["blocks"], x, positions, enc=enc)
    return apply_norm(cfg, params["final_norm"], x), aux


def _nll(cfg: ModelConfig, params: Params, h: torch.Tensor,
         tgt: torch.Tensor) -> torch.Tensor:
    lp = torch.log_softmax(_logits(cfg, params, h), dim=-1)
    return -torch.gather(lp, -1, tgt[..., None].long())[..., 0]


def loss_fn(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,
    embeds: Optional[torch.Tensor] = None,
    lb_coef: float = 0.01,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (text positions only) + MoE aux loss.

    With ``cfg.loss_chunk > 0`` the [B, S, V] logits never exist at once:
    each chunk's logits -> log-softmax -> NLL is recomputed in the backward
    pass (``torch.utils.checkpoint``), as the reference's remat scan does.
    """
    hidden, aux = hidden_forward(cfg, params, tokens, embeds=embeds)
    n_prefix = hidden.shape[1] - tokens.shape[1]
    hx = hidden[:, n_prefix : n_prefix + tokens.shape[1] - 1, :]  # predictors
    tgt = tokens[:, 1:]

    if cfg.loss_chunk and hx.shape[1] > cfg.loss_chunk:
        ck = cfg.loss_chunk
        n_tok = hx.shape[1]
        pad = (-n_tok) % ck                     # pad to a chunk multiple;
        if pad:                                 # padded positions are masked
            hx = F.pad(hx, (0, 0, 0, pad))
            tgt = F.pad(tgt, (0, pad))
        valid = torch.arange(hx.shape[1], device=hx.device) < n_tok

        def chunk_nll(h_c, t_c, v_c):
            return torch.sum(_nll(cfg, params, h_c, t_c) * v_c[None, :])

        total_nll = torch.zeros((), dtype=torch.float32, device=hx.device)
        for c in range(hx.shape[1] // ck):
            sl = slice(c * ck, (c + 1) * ck)
            total_nll = total_nll + checkpoint(chunk_nll, hx[:, sl], tgt[:, sl],
                                               valid[sl], use_reentrant=False)
        ce = total_nll / (hx.shape[0] * n_tok)
    else:
        ce = torch.mean(_nll(cfg, params, hx, tgt))
    total = ce + lb_coef * aux["lb_loss"]
    metrics = {"ce": ce, **aux}
    return total, metrics



# --------------------------------------------------------------------------
# caches: stacked per block, mirroring the block structure
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, enc_len: int = 0,
               device: DeviceLike = None) -> Params:
    """Zero decode cache, each leaf stacked over ``n_blocks`` (each block
    its own memory: ``decode_step`` writes the blocks in place)."""
    device = resolve_device(device)
    lead = (cfg.n_blocks,)
    cache: Params = {}
    for i in range(cfg.block_period):
        if cfg.layer_kind(i) == "attn":
            c = attn.init_kv_cache(cfg, batch, max_len, device, lead)
        else:
            c = ssm_mod.init_ssm_cache(cfg, batch, device, lead)
        if cfg.n_enc_layers:
            cross = attn.init_kv_cache(cfg, batch, enc_len, device, lead)
            c["cross_k"], c["cross_v"] = cross["k"], cross["v"]
        cache[f"layer_{i}"] = c
    return cache


def decode_step(
    cfg: ModelConfig,
    params: Params,
    cache: Params,
    tokens_last: torch.Tensor,          # int[B, 1]
    pos: Union[int, torch.Tensor],      # position of the new token
) -> Tuple[torch.Tensor, Params]:
    """One serve step -> (next-token logits [B, 1, V] float32, cache); the
    cache is written in place and returned."""
    pos = int(pos)

    def mixers(i, lp, lc):
        def attention(h):
            return attn.decode_self_attention(cfg, lp["attn"], lc, h, pos,
                                              cfg.layer_window(i))[0]

        def mamba(h):
            return ssm_mod.ssm_decode(cfg, lp["ssm"], lc, h)[0]

        def cross(h):
            return _decode_cross(cfg, lp["cross"], h, lc)

        return (attention if cfg.layer_kind(i) == "attn" else mamba,
                cross if "cross_k" in lc else None)

    x = _run_stack(cfg, params["blocks"], _embed(cfg, params, tokens_last), mixers, cache)
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x), cache


def _decode_cross(cfg: ModelConfig, p: Params, x: torch.Tensor, lc: Params) -> torch.Tensor:
    """Cross attention for one decode token on the cached encoder K/V."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(b, 1, cfg.n_heads, hd)
    if "bq" in p:
        q = q + p["bq"].reshape(1, 1, cfg.n_heads, hd)
    return attn._cross_attend(cfg, p, q, lc["cross_k"], lc["cross_v"])


def prefill(
    cfg: ModelConfig,
    params: Params,
    tokens: torch.Tensor,                   # int[B, S]
    embeds: Optional[torch.Tensor] = None,
    max_len: Optional[int] = None,
) -> Tuple[torch.Tensor, Params]:
    """Process a prompt -> (last-position logits [B, V] float32, cache).

    The cache holds ``max_len`` (>= S) positions, zeros past the prompt, so
    that ``decode_step`` appends."""
    x, enc = _inputs(cfg, params, tokens, embeds)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len or s, enc.shape[1] if enc is not None else 0,
                       x.device)

    def mixers(i, lp, lc):
        def attention(h):
            out, k, v = attn._self_attention_kv(cfg, lp["attn"], h, positions,
                                                cfg.layer_window(i))
            lc["k"][:, :s] = k
            lc["v"][:, :s] = v
            return out

        def mamba(h):
            out, st = ssm_mod.ssm_forward(cfg, lp["ssm"], h, return_state=True)
            lc["ssm"].copy_(st["ssm"])
            lc["conv"].copy_(st["conv"])
            return out

        def cross(h):
            q, k, v = attn._project_qkv(cfg, lp["cross"], h, kv_x=enc)
            lc["cross_k"].copy_(k)
            lc["cross_v"].copy_(v)
            return attn._cross_attend(cfg, lp["cross"], q, k, v)

        return (attention if cfg.layer_kind(i) == "attn" else mamba,
                cross if enc is not None else None)

    x = _run_stack(cfg, params["blocks"], x, mixers, cache)
    x = apply_norm(cfg, params["final_norm"], x)
    return _logits(cfg, params, x[:, -1, :]), cache
