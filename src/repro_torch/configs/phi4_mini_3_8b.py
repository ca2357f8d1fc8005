"""phi4-mini-3.8b [dense]: 32L d=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
RoPE + SwiGLU + GQA [arXiv:2412.08905; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b", family="dense", n_layers=32, d_model=3072,
    n_heads=24, n_kv=8, d_ff=8192, vocab=200064, head_dim=128,
    rope_theta=10000.0,
)

TINY = ModelConfig(
    name="phi4-tiny", family="dense", n_layers=2, d_model=96, n_heads=3,
    n_kv=1, d_ff=192, vocab=512, head_dim=32, rope_theta=10000.0,
    dtype="float32", param_dtype="float32", remat="none",
)
