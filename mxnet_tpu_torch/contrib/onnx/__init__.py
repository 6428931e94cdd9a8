"""``mx.contrib.onnx`` — ONNX export/import, the port of
``mxnet_tpu/contrib/onnx``.

Reference: ``python/mxnet/contrib/onnx/`` (mx2onnx exporter + onnx2mx
importer). The reference requires the ``onnx`` pip package; this build
speaks the protobuf wire format directly (``proto.py``), so the files it
writes are standard ONNX and no third-party dependency is needed.
"""
from .mx2onnx import export_model  # noqa: F401
from .onnx2mx import import_model  # noqa: F401

__all__ = ["export_model", "import_model"]
