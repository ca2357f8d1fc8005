"""Architecture configs. ``get_config(name)`` resolves any assigned arch."""

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config, list_configs, CONFIGS

__all__ = ["ModelConfig", "get_config", "list_configs", "CONFIGS"]
