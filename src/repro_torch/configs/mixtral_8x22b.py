"""mixtral-8x22b [moe]: 56L d=6144 48H (GQA kv=8) d_ff=16384 vocab=32768,
8 experts top-2, SWA [arXiv:2401.04088]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    mlp_type="swiglu",
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    moe_dispatch="ep_shardmap",  # SPerf iteration 5: explicit shard_map EP
)

REDUCED = ModelConfig(
    name="mixtral-8x22b-reduced",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    mlp_type="swiglu",
    n_experts=4,
    top_k=2,
    sliding_window=16,
)
