"""hymba-1.5b [hybrid]: 32L d=1600 25H (GQA kv=5) d_ff=5504 vocab=32001,
ssm_state=16 — parallel attention + mamba heads per block, meta tokens,
sliding-window attention with 3 global layers [arXiv:2411.13676; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600, n_heads=25,
    n_kv=5, d_ff=5504, vocab=32001, head_dim=64, ssm_state=16,
    ssm_head_dim=64, ssm_expand=2, sliding_window=1024,
    global_attn_layers=(0, 15, 31), n_meta_tokens=128, rope_theta=10000.0,
)

TINY = ModelConfig(
    name="hymba-tiny", family="hybrid", n_layers=2, d_model=64, n_heads=2,
    n_kv=1, d_ff=128, vocab=512, head_dim=32, ssm_state=8, ssm_head_dim=16,
    ssm_expand=2, sliding_window=8, global_attn_layers=(0,),
    n_meta_tokens=4, rope_theta=10000.0,
    dtype="float32", param_dtype="float32", remat="none",
)
