"""deepseek-v3-671b [moe]: 61L d=7168 128H d_ff(expert)=2048 vocab=129280,
MoE 256 routed experts top-8 + 1 shared, MLA (kv_lora=512, q_lora=1536,
rope_dh=64), 3 dense prefix layers d_ff=18432 [arXiv:2412.19437; hf].
MTP (multi-token prediction) head omitted for the serving cells — noted in
DESIGN.md §Arch-applicability."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe", n_layers=61, d_model=7168,
    n_heads=128, n_kv=128, d_ff=2048, vocab=129280, n_experts=256, top_k=8,
    n_shared_experts=1, first_dense_layers=3, dense_d_ff=18432,
    mla=True, q_lora_rank=1536, kv_lora_rank=512, rope_head_dim=64,
    nope_head_dim=128, v_head_dim=128, rope_theta=10000.0,
)

TINY = ModelConfig(
    name="deepseek-tiny", family="moe", n_layers=3, d_model=64, n_heads=4,
    n_kv=4, d_ff=64, vocab=512, n_experts=8, top_k=2, n_shared_experts=1,
    first_dense_layers=1, dense_d_ff=128, mla=True, q_lora_rank=32,
    kv_lora_rank=16, rope_head_dim=8, nope_head_dim=16, v_head_dim=16,
    rope_theta=10000.0, capacity_factor=8.0, dtype="float32", param_dtype="float32", remat="none",
)
