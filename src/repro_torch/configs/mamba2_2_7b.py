"""mamba2-2.7b [ssm]: 64L d=2560 attention-free, ssm_state=128 — SSD
(state-space duality) [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560, n_heads=0,
    n_kv=0, d_ff=0, vocab=50280, ssm_state=128, ssm_head_dim=64,
    ssm_expand=2, ssm_conv=4, ssm_ngroups=1, tie_embeddings=True,
)

TINY = ModelConfig(
    name="mamba2-tiny", family="ssm", n_layers=2, d_model=64, n_heads=0,
    n_kv=0, d_ff=0, vocab=512, ssm_state=16, ssm_head_dim=16, ssm_expand=2,
    ssm_conv=4, ssm_ngroups=1, tie_embeddings=True,
    dtype="float32", param_dtype="float32", remat="none",
)
