"""whisper-small [audio enc-dec]: 12+12L d=768 12H d_ff=3072 vocab=51865.
Conv frontend is a STUB: input_specs() provides precomputed frame
embeddings [B, 1500, 768] [arXiv:2212.04356]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec", n_layers=12, n_enc_layers=12,
    d_model=768, n_heads=12, n_kv=12, d_ff=3072, vocab=51865,
    norm="layernorm", act="gelu", rope=False, max_positions=32768,
    n_frames=1500,
)

TINY = ModelConfig(
    name="whisper-tiny", family="encdec", n_layers=2, n_enc_layers=2,
    d_model=64, n_heads=2, n_kv=2, d_ff=128, vocab=512, norm="layernorm",
    act="gelu", rope=False, max_positions=128, n_frames=16,
    dtype="float32", param_dtype="float32", remat="none",
)
