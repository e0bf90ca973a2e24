from .registry import ModelApi, build_model, input_specs

__all__ = ["ModelApi", "build_model", "input_specs"]
