"""Data iterators (``mxnet_tpu/io``): the ``DataIter`` protocol with
``NDArrayIter``, ``ResizeIter`` and ``PrefetchingIter``, RecordIO and
``ImageRecordIter``, and the device prefetch queue that feeds
``TrainStep.run``."""
from . import io  # noqa: F401
from .io import (DataBatch, DataDesc, DataIter, NDArrayIter,  # noqa: F401
                 PrefetchingIter, ResizeIter)
from . import prefetch  # noqa: F401
from .prefetch import DevicePrefetcher  # noqa: F401
from . import recordio  # noqa: F401
from .recordio import IndexedRecordIO, MXRecordIO  # noqa: F401
from . import image_iter  # noqa: F401
from .image_iter import ImageRecordIter  # noqa: F401

__all__ = ["io", "DataBatch", "DataDesc", "DataIter", "NDArrayIter",
           "PrefetchingIter", "ResizeIter", "prefetch", "DevicePrefetcher",
           "recordio", "MXRecordIO", "IndexedRecordIO", "image_iter",
           "ImageRecordIter"]
