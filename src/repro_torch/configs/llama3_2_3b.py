"""Llama3.2-3B — the paper's smaller case-study model (§4): 28L d=3072 24H
(GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense", n_layers=28, d_model=3072, n_heads=24,
    n_kv=8, d_ff=8192, vocab=128256, head_dim=128, rope_theta=500000.0,
)
