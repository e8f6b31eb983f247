"""dbrx-132b [moe]: 40L d=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
fine-grained MoE 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    mlp_type="swiglu",
    norm_type="layernorm",
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
    moe_dispatch="ep_shardmap",  # SPerf iteration 5: explicit shard_map EP
)

REDUCED = ModelConfig(
    name="dbrx-132b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=512,
    mlp_type="swiglu",
    norm_type="layernorm",
    n_experts=8,
    top_k=4,
)
