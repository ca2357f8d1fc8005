"""Config registry: resolve --arch ids to ModelConfigs (+ tiny variants)."""

from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import (qwen3_14b, granite_34b, olmo_1b, phi4_mini_3_8b,
                           hymba_1_5b, olmoe_1b_7b, deepseek_v3_671b,
                           mamba2_2_7b, whisper_small, llama_3_2_vision_90b,
                           llama3_8b, llama3_2_3b)

_MODULES = {
    "qwen3-14b": qwen3_14b,
    "granite-34b": granite_34b,
    "olmo-1b": olmo_1b,
    "phi4-mini-3.8b": phi4_mini_3_8b,
    "hymba-1.5b": hymba_1_5b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "deepseek-v3-671b": deepseek_v3_671b,
    "mamba2-2.7b": mamba2_2_7b,
    "whisper-small": whisper_small,
    "llama-3.2-vision-90b": llama_3_2_vision_90b,
    "llama3-8b": llama3_8b,
    "llama3.2-3b": llama3_2_3b,
}

ASSIGNED = [
    "qwen3-14b", "granite-34b", "olmo-1b", "phi4-mini-3.8b", "hymba-1.5b",
    "olmoe-1b-7b", "deepseek-v3-671b", "mamba2-2.7b", "whisper-small",
    "llama-3.2-vision-90b",
]

CONFIGS: Dict[str, ModelConfig] = {}
for _name, _mod in _MODULES.items():
    CONFIGS[_name] = _mod.CONFIG
    if hasattr(_mod, "TINY"):
        CONFIGS[_mod.TINY.name] = _mod.TINY


def get_config(name: str, tiny: bool = False) -> ModelConfig:
    if tiny:
        mod = _MODULES[name]
        return mod.TINY
    return CONFIGS[name]


def list_configs():
    return sorted(CONFIGS)
