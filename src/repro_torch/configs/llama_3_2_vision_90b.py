"""llama-3.2-vision-90b [vlm]: 100L d=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — cross-attention image layers every 5th layer; vision tower
is a STUB providing patch embeddings [B, 6404, 8192]
[hf:meta-llama/Llama-3.2-11B-Vision]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm", n_layers=100, d_model=8192,
    n_heads=64, n_kv=8, d_ff=28672, vocab=128256, head_dim=128,
    cross_attn_every=5, n_image_tokens=6404, rope_theta=500000.0,
)

TINY = ModelConfig(
    name="llama-vision-tiny", family="vlm", n_layers=4, d_model=64,
    n_heads=2, n_kv=1, d_ff=128, vocab=512, head_dim=32, cross_attn_every=2,
    n_image_tokens=8, rope_theta=10000.0,
    dtype="float32", param_dtype="float32", remat="none",
)
