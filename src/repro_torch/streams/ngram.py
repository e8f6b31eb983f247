"""Token streams as modular-key streams (the LM-framework integration),
PyTorch port of ``repro/streams/ngram.py``.

An n-gram is a key of modularity n over the vocabulary domain -- a bigram
<prev, next> is structurally a directed graph edge, the paper's flagship
example.  These helpers turn token batches into (items, freqs) blocks, so
MOD-Sketch tracks corpus n-gram statistics *during training*.  Also here:
(expert, token-bucket) pairs for MoE routing telemetry.

Keys are int64 tensors (the port's index dtype; the reference's uint32
values, which are below the vocabulary size, are unchanged).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import KeySchema


def ngram_schema(vocab_size: int, n: int) -> KeySchema:
    return KeySchema(domains=(int(vocab_size),) * n)


def ngram_items(tokens: torch.Tensor, n: int) -> torch.Tensor:
    """int[B, T] token ids -> int64[B*(T-n+1), n] n-gram keys.  Windows
    that straddle sequence boundaries are excluded by construction (per-row
    windows only)."""
    if n < 1:
        raise ValueError("n >= 1")
    b, t = tokens.shape
    if t < n:
        raise ValueError(f"sequence length {t} < n {n}")
    cols = [tokens[:, i : t - n + 1 + i] for i in range(n)]
    grams = torch.stack(cols, dim=-1)               # [B, T-n+1, n]
    return grams.reshape(-1, n).to(torch.int64)


def ngram_items_np(tokens: np.ndarray, n: int) -> np.ndarray:
    b, t = tokens.shape
    cols = [tokens[:, i : t - n + 1 + i] for i in range(n)]
    return np.stack(cols, axis=-1).reshape(-1, n).astype(np.uint32)


def moe_routing_items(
    token_ids: torch.Tensor,     # int[N] flattened tokens
    expert_ids: torch.Tensor,    # int[N, top_k] chosen experts
    n_buckets: int = 4096,
) -> torch.Tensor:
    """(expert, token-bucket) pairs: int64[N*top_k, 2].

    Token ids are bucketed (id mod n_buckets) to bound the second module's
    domain; the expert domain is tiny, so the Thm-3 optimizer allocates
    b >> a, the asymmetric-range case the paper motivates.
    """
    n, k = expert_ids.shape
    tok = token_ids[:, None].expand(n, k).reshape(-1).to(torch.int64)
    exp = expert_ids.reshape(-1).to(torch.int64)
    bucket = torch.remainder(tok, int(n_buckets))
    return torch.stack([exp, bucket], dim=-1)


def routing_schema(n_experts: int, n_buckets: int = 4096) -> KeySchema:
    return KeySchema(domains=(int(n_experts), int(n_buckets)))
