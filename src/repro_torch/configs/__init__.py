from .base import ModelConfig, MoEConfig, get_config, register

__all__ = ["ModelConfig", "MoEConfig", "get_config", "register"]
