"""Llama3.1-8B — the paper's larger case-study model (§4): 32L d=4096 32H
(GQA kv=8) d_ff=14336 vocab=128256."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense", n_layers=32, d_model=4096, n_heads=32,
    n_kv=8, d_ff=14336, vocab=128256, head_dim=128, rope_theta=500000.0,
)

TINY = ModelConfig(
    name="llama3-tiny", family="dense", n_layers=2, d_model=128, n_heads=4,
    n_kv=2, d_ff=256, vocab=512, head_dim=32, rope_theta=10000.0,
    dtype="float32", param_dtype="float32", remat="none",
)
