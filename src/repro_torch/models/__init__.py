from .registry import ModelApi, build_model

__all__ = ["ModelApi", "build_model"]
