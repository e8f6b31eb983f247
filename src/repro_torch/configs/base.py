"""Model configuration system: one frozen config per assigned architecture
(PyTorch port of ``repro/configs/base.py``; plain data, same fields).

Families:
  dense   -- decoder-only transformer (GQA/MQA, RoPE, optional SWA /
             local-global alternation / softcaps / parallel blocks)
  moe     -- dense + mixture-of-experts FFN (top-k, capacity dispatch)
  ssm     -- attention-free Mamba2 (SSD) stack
  hybrid  -- Jamba-style interleave: 1 attention per `attn_period` layers,
             MoE on alternating layers
  vlm     -- dense decoder backbone; patch-embedding frontend is a stub
             (input_specs supplies precomputed patch embeddings)
  audio   -- encoder-decoder; frame-embedding frontend is a stub

The layer stack is organized in repeating *blocks* of ``block_period``
layers so heterogeneous stacks (gemma2 local/global pairs, jamba 8-layer
periods) scan over homogeneous stacked params (DESIGN.md S5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    mlp_type: str = "swiglu"         # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    use_bias: bool = False
    parallel_block: bool = False     # command-r style attn || mlp
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: embeddings * sqrt(d)
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # 0 = full attention
    local_global_period: int = 0     # gemma2: alternate [local, global]
    attn_softcap: float = 0.0        # gemma2 tanh softcap on attn logits
    logit_softcap: float = 0.0       # gemma2 tanh softcap on final logits
    post_block_norm: bool = False    # gemma2 post-norms
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1               # MoE replaces MLP every k-th layer
    capacity_factor: float = 1.25
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv: int = 4
    attn_every: int = 0              # hybrid: attention at layer i % attn_every == attn_offset
    attn_offset: int = 0
    # --- encoder-decoder / frontends ---
    n_enc_layers: int = 0
    frontend: str = ""               # "" | patch | frame  (stub: embeds provided)
    frontend_len: int = 256          # prefix embeddings per sequence
    # --- numerics / runtime ---
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    remat: bool = True
    attn_chunk: int = 1024           # blockwise-attention q-chunk for long seqs
    attn_chunk_threshold: int = 8192 # use blockwise attention above this seq len
    sub_quadratic: bool = False      # can run long_500k decode
    loss_chunk: int = 0              # chunked cross-entropy (tokens/chunk; 0=off)
    moe_dispatch: str = "global"     # global | local (per-DP-shard capacity) |
                                     # ep_shardmap (per-position F-slices)
    moe_weight_shard: str = "2d"     # 2d (D x dp, F x mp) | f_allaxes (F x dp*mp)
    vocab_pad_multiple: int = 1      # pad embedding rows so vocab shards on TP
    # --- sketch integration (the paper's feature, on by default) ---
    sketch_ngrams: int = 2
    sketch_width: int = 5
    sketch_range: int = 1 << 16

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in ("dense", "moe", "ssm", "hybrid", "vlm", "audio"):
            raise ValueError(f"unknown family {self.family}")
        if self.family != "ssm" and self.n_heads % max(1, self.n_kv_heads):
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if self.block_period and self.n_layers % self.block_period:
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not divisible by "
                f"block period {self.block_period}"
            )

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = max(1, self.vocab_pad_multiple)
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def block_period(self) -> int:
        """Layers per scanned block (homogeneous repeating unit)."""
        if self.family == "hybrid":
            return self.attn_every or 8
        if self.local_global_period:
            return self.local_global_period
        if self.family == "moe" and self.moe_every > 1:
            return self.moe_every
        return 1

    @property
    def n_blocks(self) -> int:
        return self.n_layers // self.block_period

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def activation_dtype(self):
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def layer_kind(self, i: int) -> str:
        """Kind of layer i within a block: attn | mamba."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            return "attn" if i % self.block_period == self.attn_offset else "mamba"
        return "attn"

    def layer_window(self, i: int) -> int:
        """Sliding window for layer i (0 = full attention)."""
        if self.local_global_period:
            # even position in the period -> local (windowed), odd -> global
            return self.sliding_window if (i % self.local_global_period == 0) else 0
        return self.sliding_window

    def layer_is_moe(self, i: int) -> bool:
        if not self.n_experts:
            return False
        if self.family == "hybrid":
            return i % 2 == 1  # MoE on alternating layers (Jamba)
        return i % self.moe_every == 0

    # -- parameter count (for MODEL_FLOPS = 6*N*D roofline term) ----------
    def param_count(self) -> Dict[str, int]:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.resolved_head_dim
        qo = self.n_heads * hd
        kv = self.n_kv_heads * hd
        attn = d * qo + 2 * d * kv + qo * d
        glu = 3 * d * f if self.mlp_type in ("swiglu", "geglu") else 2 * d * f
        moe = self.n_experts * glu if self.n_experts else 0
        moe_active = self.top_k * glu if self.n_experts else 0
        din = self.ssm_inner
        nheads = self.ssm_heads if self.ssm_state else 0
        mamba = (d * (2 * din + 2 * self.ssm_state + nheads)
                 + din * d + self.ssm_conv * (din + 2 * self.ssm_state)
                 + 2 * nheads + din) if self.ssm_state else 0

        total = active = 0
        n_dec = self.n_layers
        for i in range(n_dec):
            kind = self.layer_kind(i % max(1, self.block_period))
            if kind == "attn":
                total += attn
                active += attn
            else:
                total += mamba
                active += mamba
            if self.layer_is_moe(i % max(1, self.block_period)):
                total += moe + d * self.n_experts
                active += moe_active + d * self.n_experts
            elif f:
                total += glu
                active += glu
        for _ in range(self.n_enc_layers):
            total += attn + glu
            active += attn + glu
        if self.n_enc_layers:  # decoder cross-attention
            total += n_dec * attn
            active += n_dec * attn
        emb = v * d * (1 if self.tie_embeddings else 2)
        total += emb
        active += emb
        return {"total": total, "active": active}
