"""Layer-stack assembly for training: init, forward and the loss, PyTorch
port of ``repro/models/transformer.py`` for the ``dense`` and ``vlm``
families.

The parameters keep the reference's layout: the blocks' leaves are
*stacked*, one tensor of shape ``[n_blocks, ...]`` per leaf, and the stack
is a Python loop over the blocks (in place of ``lax.scan``), each block
holding ``cfg.block_period`` sublayers with a static kind (local/global
window).  The layout matters beyond the forward: the gradient compressor
plans and hashes each leaf by its shape (rows = prod(shape[:-1])), so
per-layer leaves would be sketched differently.  Remat is not applied:
the sizes this port trains fit without it.

MoE, SSM, hybrid and encoder-decoder (audio) stacks, prefill, decode and
the KV cache are not ported yet (ROADMAP item 15); their entry points
raise ``NotImplementedError`` naming it.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import attention as attn
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
FAMILIES = ("dense", "vlm")


def require_ported(cfg: ModelConfig, entry: str) -> None:
    """Refuse the families whose layers are not ported yet."""
    if cfg.family not in FAMILIES or cfg.n_enc_layers:
        raise NotImplementedError(
            f"{entry}: {cfg.name} is a {cfg.family} model; the port runs the "
            "dense and vlm families so far -- MoE, SSM, hybrid and "
            "encoder-decoder stacks arrive with ROADMAP item 15 (model stack)")


# ==========================================================================
# init
# ==========================================================================

def _make_block_params(cfg: ModelConfig, generator: torch.Generator,
                       device) -> Params:
    """Every sublayer position of a block, each leaf stacked over blocks."""
    lead = (cfg.n_blocks,)
    d = cfg.d_model
    block: Params = {}
    for i in range(cfg.block_period):
        p: Params = {"norm1": make_norm_params(cfg, d, device, lead),
                     "attn": attn.make_attn_params(cfg, generator, device, lead)}
        if cfg.d_ff and not cfg.parallel_block:
            p["norm2"] = make_norm_params(cfg, d, device, lead)
        if cfg.d_ff:
            p["mlp"] = make_mlp_params(cfg, generator, d, cfg.d_ff, device, lead)
        if cfg.post_block_norm:
            p["post_attn_norm"] = make_norm_params(cfg, d, device, lead)
            if cfg.d_ff:
                p["post_ff_norm"] = make_norm_params(cfg, d, device, lead)
        block[f"layer_{i}"] = p
    return block


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Params:
    """Fresh parameters drawn from ``generator``, in the reference's tree.
    ``device="meta"`` gives their shapes and dtypes without memory (the
    port's ``jax.eval_shape`` of the reference's init)."""
    require_ported(cfg, "init_params")
    device = resolve_device(device)
    dt = cfg.activation_dtype
    params: Params = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, device),
        "blocks": _make_block_params(cfg, generator, device),
        "final_norm": make_norm_params(cfg, cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.padded_vocab,
                                       dt, device)
    return params


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for x in tr.leaves(params))


# ==========================================================================
# forward building blocks
# ==========================================================================

def _unstack(cfg: ModelConfig, blocks: Params) -> List[Params]:
    """The stacked block tree as one tree per block (views, no copies)."""
    pairs = tr.flatten(blocks)
    parts = [torch.unbind(leaf, 0) for _, leaf in pairs]
    return [tr.unflatten((path, part[b]) for (path, _), part in zip(pairs, parts))
            for b in range(cfg.n_blocks)]


def _apply_layer_train(cfg: ModelConfig, lp: Params, x: torch.Tensor,
                       positions: torch.Tensor, i: int) -> torch.Tensor:
    h = apply_norm(cfg, lp["norm1"], x)
    mix = attn.self_attention(cfg, lp["attn"], h, positions, cfg.layer_window(i))
    if cfg.post_block_norm:
        mix = apply_norm(cfg, lp["post_attn_norm"], mix)

    if cfg.parallel_block and "mlp" in lp:
        return x + mix + apply_mlp(cfg, lp["mlp"], h)
    x = x + mix
    if "mlp" in lp:
        h2 = apply_norm(cfg, lp["norm2"], x)
        y = apply_mlp(cfg, lp["mlp"], h2)
        if cfg.post_block_norm:
            y = apply_norm(cfg, lp["post_ff_norm"], y)
        x = x + y
    return x


def _stack_forward(cfg: ModelConfig, blocks: Params, x: torch.Tensor,
                   positions: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Loop over the stacked blocks; returns (hidden, summed aux).  The
    dense families carry no MoE aux losses, so both sums are 0."""
    for bp in _unstack(cfg, blocks):
        for i in range(cfg.block_period):
            x = _apply_layer_train(cfg, bp[f"layer_{i}"], x, positions, i)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, {"lb_loss": zero, "dropped_frac": zero}


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
    require_ported(cfg, "hidden_forward")
    x = _embed(cfg, params, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _stack_forward(cfg, params["blocks"], x, positions)
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

