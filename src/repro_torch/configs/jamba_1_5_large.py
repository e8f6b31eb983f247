"""jamba-1.5-large-398b [hybrid]: 72L d=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, Mamba+attention 1:7 interleave, MoE 16e top-2 on alternating
layers [arXiv:2403.19887].

Hardware-adaptation note (DESIGN.md S4): Jamba's Mamba-1 layers are
implemented with the Mamba2/SSD chunked formulation -- same recurrence
shape, MXU-friendly (scalar-per-head A instead of per-channel); the
system-level compute/memory profile is preserved.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    mlp_type="swiglu",
    n_experts=16,
    top_k=2,
    attn_every=8,        # 1 attention layer per 8 (1:7 attn:mamba)
    attn_offset=4,
    ssm_state=16,
    ssm_head_dim=128,    # d_inner = 16384 -> 128 SSD heads
    ssm_expand=2,
    ssm_chunk=128,
    sub_quadratic=True,  # 1/8 attention layers: decode-time KV is tractable
    moe_dispatch="ep_shardmap",  # SPerf iteration 5: explicit shard_map EP
)

REDUCED = ModelConfig(
    name="jamba-1.5-large-398b-reduced",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    mlp_type="swiglu",
    n_experts=4,
    top_k=2,
    attn_every=8,
    attn_offset=4,
    ssm_state=8,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_chunk=16,
    sub_quadratic=True,
)
