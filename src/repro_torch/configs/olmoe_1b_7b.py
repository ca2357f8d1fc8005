"""olmoe-1b-7b [moe]: 16L d=2048 16H (kv=16) expert d_ff=1024 vocab=50304,
64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048, n_heads=16,
    n_kv=16, d_ff=1024, vocab=50304, n_experts=64, top_k=8,
    rope_theta=10000.0, qk_norm=True,
)

TINY = ModelConfig(
    name="olmoe-tiny", family="moe", n_layers=2, d_model=64, n_heads=2,
    n_kv=2, d_ff=64, vocab=512, n_experts=8, top_k=2, rope_theta=10000.0,
    qk_norm=True, capacity_factor=8.0, dtype="float32", param_dtype="float32", remat="none",
)
