"""Bridge between the relational path's Appendix-A weight layout and the
model stack's parameter tree (dense Llama family only).

Used by the equivalence tests, the quickstart example and the GPU smoke run
to show that the two execution paths (relational pipelines vs the dense
model) implement the same model, weight-for-weight.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.chunked import resolve_device
from repro_torch.core.llama_graph import LlamaSpec


def spec_to_config(spec: LlamaSpec, dtype: str = "float32") -> ModelConfig:
    return ModelConfig(
        name="llama-bridge", family="dense", n_layers=spec.n_layers,
        d_model=spec.d_model, n_heads=spec.n_heads, n_kv=spec.n_kv,
        d_ff=spec.d_ff, vocab=spec.vocab, head_dim=spec.head_dim,
        rope_theta=spec.rope_theta, eps=spec.eps, dtype=dtype,
        param_dtype=dtype, remat="none",
    )


def llama_params_to_tree(params: Dict[str, object], spec: LlamaSpec,
                         device="cuda") -> Dict:
    """Appendix-A tables (numpy arrays or tensors) → the
    ``models/transformer`` parameter tree on ``device`` (layers stacked).
    Every leaf is a new contiguous tensor."""
    device = resolve_device(device)
    L = spec.n_layers

    def t(name):
        return torch.as_tensor(params[name]).to(device)

    def stack(fn):
        return torch.stack([fn(i) for i in range(L)])

    d, dh = spec.d_model, spec.head_dim
    g0 = {
        "ln1": {"scale": stack(lambda i: t(f"Attention_Norm_L{i}"))},
        "ln2": {"scale": stack(lambda i: t(f"FFN_Norm_L{i}"))},
        "attn": {
            # [H, dh, D] → [D, H, dh]
            "wq": stack(lambda i: t(f"Q_weights_L{i}").permute(2, 0, 1)),
            "wk": stack(lambda i: t(f"K_weights_L{i}").permute(2, 0, 1)),
            "wv": stack(lambda i: t(f"V_weights_L{i}").permute(2, 0, 1)),
            # [Dout, Din] → [H, dh, Dout]
            "wo": stack(lambda i: t(f"o_weights_L{i}").T.reshape(
                spec.n_heads, dh, d)),
        },
        "mlp": {
            "w1": stack(lambda i: t(f"GLU_W1_L{i}").T),
            "w3": stack(lambda i: t(f"GLU_W3_L{i}").T),
            "w2": stack(lambda i: t(f"GLU_W2_L{i}").T),
        },
    }
    return {
        "embed": {"embedding": t("vocabulary").clone()},
        "g0": g0,
        "final_norm": {"scale": t("Final_Norm").clone()},
        "lm_head": t("lm_head").T.contiguous(),
    }
