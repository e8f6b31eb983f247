"""starcoder2-7b [dense]: 32L d=4608 36H (GQA kv=4) d_ff=18432 vocab=49152,
RoPE, LayerNorm + biases, gelu MLP [arXiv:2402.19173]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    mlp_type="gelu",
    norm_type="layernorm",
    use_bias=True,
    rope_theta=100_000.0,
)

REDUCED = ModelConfig(
    name="starcoder2-7b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    mlp_type="gelu",
    norm_type="layernorm",
    use_bias=True,
)
