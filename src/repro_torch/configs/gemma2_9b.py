"""gemma2-9b [dense]: 42L d=3584 16H (GQA kv=8) d_ff=14336 vocab=256000,
local(4096)+global alternating, attn softcap 50, logit softcap 30, GeGLU,
head_dim=256, post-norms [arXiv:2408.00118]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    n_layers=42,
    d_model=3584,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    mlp_type="geglu",
    embed_scale=True,
    tie_embeddings=True,
    sliding_window=4096,
    local_global_period=2,     # [local, global] pairs
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_block_norm=True,
)

REDUCED = ModelConfig(
    name="gemma2-9b-reduced",
    family="dense",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp_type="geglu",
    embed_scale=True,
    tie_embeddings=True,
    sliding_window=16,
    local_global_period=2,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_block_norm=True,
)
