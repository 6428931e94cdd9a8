"""Contrib modules of the port: ``amp`` (mixed precision),
``quantization`` (INT8 post-training quantization and the int8 kernels) and
``onnx`` (ONNX export and import)."""
from . import amp
from . import quantization
from . import onnx

__all__ = ["amp", "quantization", "onnx"]
