"""internvl2-26b [vlm]: InternLM2-20B backbone, 48L d=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553 [arXiv:2404.16821].  InternViT frontend is a stub:
input_specs() provides precomputed patch embeddings (assignment note)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    frontend="patch",
    frontend_len=256,
)

REDUCED = ModelConfig(
    name="internvl2-26b-reduced",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    mlp_type="swiglu",
    frontend="patch",
    frontend_len=8,
)
