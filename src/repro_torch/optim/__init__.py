from .compression import dequantize_rows, quantize_rows

__all__ = ["dequantize_rows", "quantize_rows"]
