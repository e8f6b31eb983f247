"""mamba2-130m [ssm]: 24L d_model=768, attention-free SSD, vocab 50280,
ssm_state=128 [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,          # unused (attention-free); kept for uniform tooling
    n_kv_heads=12,
    d_ff=0,              # no MLP: pure Mamba2 blocks
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,     # d_inner = 2*768 = 1536 -> 24 SSD heads
    ssm_expand=2,
    ssm_chunk=128,
    tie_embeddings=True,
    norm_type="rmsnorm",
    sub_quadratic=True,  # O(1)-state decode: runs long_500k
)

REDUCED = ModelConfig(
    name="mamba2-130m-reduced",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    d_ff=0,
    vocab_size=512,
    ssm_state=16,
    ssm_head_dim=32,
    ssm_expand=2,
    ssm_chunk=16,
    tie_embeddings=True,
    sub_quadratic=True,
)
