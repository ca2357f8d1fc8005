"""granite-34b [dense]: 88L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
llama-arch, code [arXiv:2405.04324; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense", n_layers=88, d_model=6144, n_heads=48,
    n_kv=1, d_ff=24576, vocab=49152, head_dim=128, rope_theta=10000.0,
)

TINY = ModelConfig(
    name="granite-tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv=1, d_ff=256, vocab=512, head_dim=32, rope_theta=10000.0,
    dtype="float32", param_dtype="float32", remat="none",
)
