"""gemma-7b [dense]: 28L d=3072 16H (GQA kv=16, i.e. MHA on 7b; MQA is the
2b variant) d_ff=24576 GeGLU head_dim=256 vocab=256000 [arXiv:2403.08295]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="geglu",
    embed_scale=True,
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="gemma-7b-reduced",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    mlp_type="geglu",
    embed_scale=True,
    tie_embeddings=True,
)
