"""Data iterators (``mxnet_tpu/io``): the ``DataIter`` protocol with
``NDArrayIter``, ``ResizeIter`` and ``PrefetchingIter``, and the device
prefetch queue that feeds ``TrainStep.run``. RecordIO and the image
iterators wait: they read files the repo does not hold."""
from . import io  # noqa: F401
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter,  # noqa: F401
                 PrefetchingIter, ResizeIter)
from . import prefetch  # noqa: F401
from .prefetch import DevicePrefetcher  # noqa: F401

__all__ = ["io", "DataBatch", "DataDesc", "DataIter", "NDArrayIter",
           "PrefetchingIter", "ResizeIter", "prefetch", "DevicePrefetcher"]
