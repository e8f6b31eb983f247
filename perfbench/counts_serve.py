"""Model FLOPs and the bytes a decode step must read, for the serving
cells, counted from shapes by the benchmark's own formulas (none is read
from the program).

FLOPs are the model's: two per multiply-add of every matrix product a
token needs (the attention projections, the router, its ``top_k``
experts' SwiGLU, and the head where a token's logits are served: the last
prompt position and every decode step, as greedy serving needs no other),
plus causal attention, 4 * n_heads * head_dim * (keys seen) per query and
layer (q k^T and the weighted sum of values).  Work that the program adds
(capacity padding, recomputation) is not counted.

Bytes follow the on-chip guide's rule: each input read once, each output
written once.  A decode step must read every weight outside the experts,
the embedding rows of its tokens, the experts its tokens route to in
each layer, and the key/value cache up to its position; it writes the new
keys and values and the float32 logits.
"""
from __future__ import annotations

from typing import Iterable

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, no sparsity, at 700 W
BF16_FLOPS_PER_S = 989.4e12
BF16, F32 = 2, 4


def _dims(m: dict):
    hd = m["d_model"] // m["n_heads"]
    return m["n_layers"], m["d_model"], m["n_heads"], m["n_kv_heads"], hd, m["d_ff"]


def attn_params(m: dict) -> int:
    """Matrix parameters of one layer's attention projections."""
    _, d, h, kv, hd, _ = _dims(m)
    return d * h * hd + 2 * d * kv * hd + h * hd * d


def expert_params(m: dict) -> int:
    """Matrix parameters of one expert (gate, in, out)."""
    return 3 * m["d_model"] * m["d_ff"]


def token_flops(m: dict) -> int:
    """FLOPs of one token's matrix products through the layers (no head)."""
    per_layer = attn_params(m) + m["d_model"] * m["n_experts"] + m["top_k"] * expert_params(m)
    return 2 * m["n_layers"] * per_layer


def head_flops(m: dict) -> int:
    return 2 * m["d_model"] * m["vocab_size"]


def attention_flops(m: dict, keys_seen: int) -> int:
    """Causal attention of queries that see ``keys_seen`` keys in all, over the layers."""
    n_layers, _, h, _, hd, _ = _dims(m)
    return 4 * n_layers * h * hd * keys_seen


def prefill_flops(m: dict, batch: int, prompt: int) -> int:
    """A cohort's prefill: every prompt token, the head at the last position."""
    return batch * (prompt * token_flops(m) + head_flops(m)
                    + attention_flops(m, prompt * (prompt + 1) // 2))


def decode_flops(m: dict, batch: int, pos: int) -> int:
    """One decode step of ``batch`` tokens at position ``pos`` (0-based)."""
    return batch * (token_flops(m) + head_flops(m) + attention_flops(m, pos + 1))


def decode_bytes(m: dict, batch: int, pos: int, experts_read: Iterable[int]) -> int:
    """Bytes one decode step at position ``pos`` must move; ``experts_read``
    gives, for each layer, how many distinct experts its tokens route to."""
    n_layers, d, _, kv, hd, _ = _dims(m)
    weights = (n_layers * (attn_params(m) + 2 * d) * BF16       # projections, two norms
               + n_layers * d * m["n_experts"] * F32            # float32 router
               + d * BF16                                        # final norm
               + d * m["vocab_size"] * BF16                      # head
               + batch * d * BF16)                               # the tokens' embedding rows
    experts = sum(experts_read) * expert_params(m) * BF16
    cache = n_layers * 2 * batch * (pos + 1) * kv * hd * BF16    # keys and values read
    written = n_layers * 2 * batch * kv * hd * BF16 + batch * m["vocab_size"] * F32
    return weights + experts + cache + written
