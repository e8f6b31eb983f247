"""command-r-35b [dense]: 40L d=8192 64H (GQA kv=8) d_ff=22528 vocab=256000,
no-bias, parallel attn||mlp blocks [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    mlp_type="swiglu",
    use_bias=False,
    parallel_block=True,
    tie_embeddings=True,
    norm_type="layernorm",
    rope_theta=8_000_000.0,
)

REDUCED = ModelConfig(
    name="command-r-35b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    mlp_type="swiglu",
    parallel_block=True,
    tie_embeddings=True,
    norm_type="layernorm",
)
