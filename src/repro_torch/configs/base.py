"""Model configuration schema covering all assigned architecture families.

A copy of the reference's schema.  The execution fields ``scan_unroll``,
``remat``, ``ce_impl`` and ``moe_impl`` keep the reference's values: the
port ignores ``scan_unroll``, honours ``remat`` and ``ce_impl`` in
training (inference ignores them), and ``moe_impl="ep_local"`` falls back
to ``moe_apply`` without a device mesh, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # norms / attention
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    parametric_norm: bool = True     # olmo: non-parametric LN
    qk_norm: bool = False            # qwen3
    act: str = "silu"                # silu (SwiGLU) | gelu (plain MLP)
    rope: bool = True                # False → learned absolute positions
    rope_theta: float = 500000.0
    max_positions: int = 4096        # for learned positions only

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    first_dense_layers: int = 0      # deepseek: 3 dense layers before MoE
    dense_d_ff: int = 0              # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_normalize: bool = True

    # MLA (deepseek-v3)
    mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128

    # SSM (mamba2 / hymba)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # hybrid (hymba)
    sliding_window: int = 0          # 0 → full attention
    global_attn_layers: Tuple[int, ...] = ()
    n_meta_tokens: int = 0

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_frames: int = 1500             # stub audio frontend output length

    # vlm (llama-3.2-vision)
    cross_attn_every: int = 0        # a cross-attn layer each N layers
    n_image_tokens: int = 0          # stub vision frontend output length

    # numerics / execution
    scan_unroll: int = 1     # lax.scan unroll: dry-run sets n_layers so XLA
                             # cost analysis sees every layer (scan bodies
                             # are otherwise counted once, not × trip-count)
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    remat: str = "full"              # none | full — activation checkpointing
    ce_impl: str = "gather"          # gather | onehot — cross-entropy gold-
                                     # logit extraction; "onehot" partitions
                                     # cleanly over a model-sharded vocab
    moe_impl: str = "dense"          # dense | ep_local — ep_local dispatches
                                     # tokens inside shard_map so the combine
                                     # is one psum, not an expert-buffer
                                     # all-gather (§Perf hillclimb B)
    tie_embeddings: bool = False
    eps: float = 1e-5

    def __post_init__(self):
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))

    # -- derived --------------------------------------------------------------

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid sliding-window)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Approximate total parameter count (for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        n = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            n += self._layer_params(i)
        if self.family == "encdec":
            for _ in range(self.n_enc_layers):
                n += self._enc_layer_params()
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        d, v = self.d_model, self.vocab
        n = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            n += self._layer_params(i, active_only=True)
        if self.family == "encdec":
            for _ in range(self.n_enc_layers):
                n += self._enc_layer_params()
        return n

    def _attn_params(self) -> int:
        d, dh = self.d_model, self.head_dim
        if self.mla:
            qr, kvr = self.q_lora_rank, self.kv_lora_rank
            qd = self.nope_head_dim + self.rope_head_dim
            return (d * qr + qr * self.n_heads * qd
                    + d * (kvr + self.rope_head_dim)
                    + kvr * self.n_heads * (self.nope_head_dim
                                            + self.v_head_dim)
                    + self.n_heads * self.v_head_dim * d)
        return d * dh * (self.n_heads + 2 * self.n_kv) + self.n_heads * dh * d

    def _ffn_params(self, d_ff: int) -> int:
        mult = 3 if self.act == "silu" else 2
        return mult * self.d_model * d_ff

    def _ssm_params(self) -> int:
        di, g, s = self.d_inner, self.ssm_ngroups, self.ssm_state
        proj_in = self.d_model * (2 * di + 2 * g * s + self.ssm_heads)
        conv = self.ssm_conv * (di + 2 * g * s)
        return proj_in + conv + 3 * self.ssm_heads + di + di * self.d_model

    def _layer_params(self, i: int, active_only: bool = False) -> int:
        if self.family == "ssm":
            return self._ssm_params()
        n = self._attn_params()
        if self.family == "hybrid":
            n += self._ssm_params()
        if self.family == "moe" and i >= self.first_dense_layers:
            k = (self.top_k + self.n_shared_experts) if active_only else \
                (self.n_experts + self.n_shared_experts)
            n += k * self._ffn_params(self.d_ff)
            n += self.d_model * self.n_experts  # router
        elif self.family == "moe":
            n += self._ffn_params(self.dense_d_ff or self.d_ff)
        else:
            n += self._ffn_params(self.d_ff)
        if self.family == "vlm" and self.cross_attn_every and \
                (i + 1) % self.cross_attn_every == 0:
            n += self._attn_params()  # the cross-attention block
        if self.family == "encdec":
            n += self._attn_params()  # decoder cross-attention
        return n

    def _enc_layer_params(self) -> int:
        return self._attn_params() + self._ffn_params(self.d_ff)
