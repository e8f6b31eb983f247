"""Shape-and-dtype stand-ins for every step's inputs, PyTorch port of
``repro/launch/specs.py``.

The stand-ins are tensors on ``torch.device("meta")``: a shape and a dtype,
no memory.  Parameter, optimizer and cache trees come from the port's real
init functions run on meta (the reference's ``jax.eval_shape``), so the
dry-run counts the exact structures the runtime would build.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.training import train_loop as tl
from repro_torch.training.optimizer import OptimizerConfig

PyTree = Any
META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def _generator() -> torch.Generator:
    return torch.Generator().manual_seed(0)


def meta_params(cfg: ModelConfig) -> PyTree:
    """The param tree on meta."""
    return tfm.init_params(cfg, _generator(), META)


def train_state_specs(cfg: ModelConfig, tcfg: tl.TrainConfig) -> PyTree:
    """``init_train_state`` on meta: params + opt (+ sketch) shapes."""
    return tl.init_train_state(cfg, tcfg, _generator(), META)


def batch_input_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    """Token batch (+ stub frontend embeddings) for one train/prefill step."""
    out: Dict[str, Any] = {}
    if cfg.n_enc_layers:
        # enc-dec: seq budget split between source frames and target tokens
        s_dec = max(2, seq // 2)
        out["tokens"] = sds((batch, s_dec), torch.int32)
        out["embeds"] = sds((batch, seq - s_dec, cfg.d_model), cfg.activation_dtype)
    elif cfg.frontend:
        s_text = max(2, seq - cfg.frontend_len)
        out["tokens"] = sds((batch, s_text), torch.int32)
        out["embeds"] = sds((batch, cfg.frontend_len, cfg.d_model), cfg.activation_dtype)
    else:
        out["tokens"] = sds((batch, seq), torch.int32)
    return out


def decode_cache_specs(cfg: ModelConfig, batch: int, seq: int) -> PyTree:
    enc_len = cfg.frontend_len if cfg.n_enc_layers else 0
    return tfm.init_cache(cfg, batch, seq, enc_len=enc_len, device=META)


def prefill_cache_specs(cfg: ModelConfig, batch: int, seq: int) -> PyTree:
    """The caches ``prefill`` returns for :func:`batch_input_specs`' batch
    (``max_len`` = the prompt: a frontend's prefix and its text tokens;
    an encoder-decoder's cross caches hold the source frames)."""
    inputs = batch_input_specs(cfg, batch, seq)
    s = inputs["tokens"].shape[1]
    enc_len = 0
    if cfg.n_enc_layers:
        enc_len = inputs["embeds"].shape[1]
    elif "embeds" in inputs:
        s += inputs["embeds"].shape[1]
    return tfm.init_cache(cfg, batch, s, enc_len=enc_len, device=META)


def decode_input_specs(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    return {
        "cache": decode_cache_specs(cfg, batch, seq),
        "tokens_last": sds((batch, 1), torch.int32),
        "pos": sds((), torch.int32),
    }


def input_specs(arch: str, shape_name: str,
                tcfg: Optional[tl.TrainConfig] = None) -> Dict[str, Any]:
    """All meta inputs for one (arch x shape) dry-run cell."""
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    b, s = sh["global_batch"], sh["seq_len"]
    tcfg = tcfg or default_train_config(cfg)
    kind = sh["kind"]
    if kind == "train":
        return {"kind": "train", "state": train_state_specs(cfg, tcfg),
                "batch": batch_input_specs(cfg, b, s)}
    if kind == "prefill":
        return {"kind": "prefill", "params": meta_params(cfg),
                "batch": batch_input_specs(cfg, b, s)}
    # decode: one new token against a seq_len cache
    return {"kind": "decode", "params": meta_params(cfg), **decode_input_specs(cfg, b, s)}


def default_train_config(cfg: ModelConfig) -> tl.TrainConfig:
    """Per-arch training defaults: int8 moments above 60e9 params."""
    n = cfg.param_count()["total"]
    opt = OptimizerConfig(name="adamw8bit" if n > 60e9 else "adamw")
    return tl.TrainConfig(optimizer=opt)
