from .base import (SHAPES, ModelConfig, MoEConfig, ShapeConfig,
                   applicable_shapes, get_config, register)

__all__ = ["SHAPES", "ModelConfig", "MoEConfig", "ShapeConfig",
           "applicable_shapes", "get_config", "register"]
