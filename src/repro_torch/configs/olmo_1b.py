"""olmo-1b [dense]: 16L d=2048 16H (kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm [arXiv:2402.00838; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense", n_layers=16, d_model=2048, n_heads=16,
    n_kv=16, d_ff=8192, vocab=50304, norm="layernorm", parametric_norm=False,
    rope_theta=10000.0, tie_embeddings=True,
)

TINY = ModelConfig(
    name="olmo-tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv=4, d_ff=256, vocab=512, norm="layernorm", parametric_norm=False,
    rope_theta=10000.0, tie_embeddings=True,
    dtype="float32", param_dtype="float32", remat="none",
)
