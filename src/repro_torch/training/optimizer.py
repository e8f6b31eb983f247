"""Optimizers built from scratch: AdamW and blockwise-int8 AdamW, PyTorch
port of ``repro/training/optimizer.py``.

The int8 variant stores both moments quantized per 128-element block along
the last axis (absmax scaling; the second moment in the sqrt domain),
cutting optimizer state from 8 to about 2.07 bytes a parameter.  Leaves
that are not a whole number of blocks stay float32.

Trees are nested dicts walked in the reference's leaf order
(``repro_torch.tree``).  The arithmetic is the reference's, in float32 with
the same Python scalars: ``torch.round`` rounds half to even as
``jnp.round`` does, and :func:`lr_schedule` runs in float32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch import tree as tr

PyTree = Any
_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"          # adamw | adamw8bit
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac * lr, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.lr * step / max(1, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    cos = cfg.min_lr_frac * cfg.lr + (1 - cfg.min_lr_frac) * cfg.lr \
        * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tr.leaves(tree)))


def clip_by_global_norm(tree: PyTree, max_norm: float) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tr.map_leaves(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                         tree), norm


# --------------------------------------------------------------------------
# int8 blockwise moment quantization
# --------------------------------------------------------------------------

def _quantizable(x: torch.Tensor) -> bool:
    return x.dim() >= 1 and x.shape[-1] % _BLOCK == 0 and x.numel() >= _BLOCK


def _quantize_sym(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x[..., D] -> (int8[..., D], float32 scales[..., D/BLOCK])."""
    xb = x.reshape(*x.shape[:-1], x.shape[-1] // _BLOCK, _BLOCK)
    scale = torch.amax(torch.abs(xb), dim=-1) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale


def _dequantize_sym(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    qb = q.reshape(*q.shape[:-1], q.shape[-1] // _BLOCK, _BLOCK)
    return (qb.to(torch.float32) * scale[..., None]).reshape(q.shape)


class Moment8(NamedTuple):
    q: torch.Tensor       # int8, param shape
    scale: torch.Tensor   # float32, param shape with last dim / BLOCK


# --------------------------------------------------------------------------
# state init / update
# --------------------------------------------------------------------------

def init_state(cfg: OptimizerConfig, params: PyTree) -> Dict[str, PyTree]:
    def zeros_like_moment(p):
        if cfg.name == "adamw8bit" and _quantizable(p):
            return Moment8(
                q=torch.zeros(p.shape, dtype=torch.int8, device=p.device),
                scale=torch.zeros((*p.shape[:-1], p.shape[-1] // _BLOCK),
                                  dtype=torch.float32, device=p.device))
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    device = tr.leaves(params)[0].device
    return {
        "m": tr.map_leaves(zeros_like_moment, params),
        "v": tr.map_leaves(zeros_like_moment, params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }


def _load_moment(x, sqrt_domain: bool = False) -> torch.Tensor:
    if isinstance(x, Moment8):
        v = _dequantize_sym(x.q, x.scale)
        return torch.square(v) if sqrt_domain else v
    return x


def _store_moment(val: torch.Tensor, like, sqrt_domain: bool = False):
    if isinstance(like, Moment8):
        # second moments span a huge dynamic range; quantizing sqrt(v)
        # halves the exponent range and keeps small denominators accurate
        q, s = _quantize_sym(torch.sqrt(val) if sqrt_domain else val)
        return Moment8(q=q, scale=s)
    return val


def apply_updates(
    cfg: OptimizerConfig,
    params: PyTree,
    grads: PyTree,
    state: Dict[str, PyTree],
) -> Tuple[PyTree, Dict[str, PyTree], Dict[str, torch.Tensor]]:
    """AdamW step (decoupled weight decay), moments maybe int8-blockwise.
    Returns new params and state; the inputs are not modified."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    flat_p = tr.flatten(params)
    flat_g = dict(tr.flatten(grads))
    flat_m = dict(tr.flatten(state["m"]))
    flat_v = dict(tr.flatten(state["v"]))

    new_p, new_m, new_v = [], [], []
    for path, p in flat_p:
        g, m0, v0 = flat_g[path].to(torch.float32), flat_m[path], flat_v[path]
        m = b1 * _load_moment(m0) + (1 - b1) * g
        v = b2 * _load_moment(v0, sqrt_domain=True) + (1 - b2) * torch.square(g)
        mh = m / bc1
        vh = v / bc2
        upd = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.to(torch.float32)
        new_p.append((path, (p.to(torch.float32) - lr * upd).to(p.dtype)))
        new_m.append((path, _store_moment(m, m0)))
        new_v.append((path, _store_moment(v, v0, sqrt_domain=True)))

    state = {"m": tr.unflatten(new_m), "v": tr.unflatten(new_v), "step": step}
    return tr.unflatten(new_p), state, {"lr": lr, "grad_norm": gnorm}


def state_bytes(state: Dict[str, PyTree]) -> int:
    total = 0
    for leaf in tr.leaves(state):
        parts = leaf if isinstance(leaf, Moment8) else (leaf,)
        total += sum(x.numel() * x.element_size() for x in parts)
    return total
