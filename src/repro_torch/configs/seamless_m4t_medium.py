"""seamless-m4t-medium [audio]: enc-dec, 12L each, d=1024 16H (MHA kv=16)
d_ff=4096 vocab=256206 [arXiv:2308.11596].  The speech frontend
(conformer feature extractor) is a stub per the assignment: input_specs()
provides precomputed frame embeddings for the encoder."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,          # decoder layers
    n_enc_layers=12,      # encoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    mlp_type="gelu",
    norm_type="layernorm",
    use_bias=True,
    frontend="frame",
    frontend_len=256,
)

REDUCED = ModelConfig(
    name="seamless-m4t-medium-reduced",
    family="audio",
    n_layers=2,
    n_enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    mlp_type="gelu",
    norm_type="layernorm",
    use_bias=True,
    frontend="frame",
    frontend_len=8,
)
