"""KV/SSM cache utilities for the serving engine, PyTorch port of
``repro/serving/kv_cache.py``.

The cache structures themselves are defined next to the layers that use
them (attention.init_kv_cache, ssm.init_ssm_cache) and stacked per block by
transformer.init_cache; this module adds serving-side helpers: sizing and
clearing slots for reuse.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import transformer as tfm

PyTree = Any


def cache_bytes(cache: PyTree) -> int:
    """Total bytes held by a decode cache (capacity planning)."""
    return sum(x.numel() * x.element_size() for x in tr.leaves(cache))


def new_cache(cfg: ModelConfig, batch: int, max_len: int,
              device: DeviceLike = None) -> PyTree:
    enc_len = cfg.frontend_len if cfg.n_enc_layers else 0
    return tfm.init_cache(cfg, batch, max_len, enc_len=enc_len, device=device)


def reset_slots(cache: PyTree, slot_mask) -> PyTree:
    """Zero the cache rows of finished slots (bool[B]) for reuse; returns a
    new tree, as the reference does (``cache`` is left as it was)."""
    slot_mask = torch.as_tensor(slot_mask, dtype=torch.bool)

    def z(x):
        if x.ndim >= 2 and x.shape[1] == slot_mask.shape[0]:
            keep = (~slot_mask).to(device=x.device, dtype=x.dtype)
            return x * keep.reshape((1, -1) + (1,) * (x.ndim - 2))
        return x
    return tr.map_leaves(z, cache)
