"""qwen3-14b [dense]: 40L d=5120 40H (GQA kv=8) d_ff=17408 vocab=151936.
qk_norm + GQA [hf:Qwen/Qwen3-8B; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense", n_layers=40, d_model=5120, n_heads=40,
    n_kv=8, d_ff=17408, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1000000.0,
)

TINY = ModelConfig(
    name="qwen3-tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv=2, d_ff=256, vocab=512, head_dim=32, qk_norm=True,
    rope_theta=10000.0, dtype="float32", param_dtype="float32", remat="none",
)
