"""gluon.data (``mxnet_tpu/gluon/data``): datasets, samplers, the
DataLoader, and the vision datasets and transforms (``vision``)."""
from . import dataset, sampler, dataloader  # noqa: F401
from .dataset import (ArrayDataset, Dataset, RecordFileDataset,  # noqa: F401
                      SimpleDataset)
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequentialSampler)
from .dataloader import DataLoader  # noqa: F401
from . import vision  # noqa: F401

__all__ = ["dataset", "sampler", "dataloader", "vision", "Dataset",
           "ArrayDataset", "SimpleDataset", "RecordFileDataset", "Sampler",
           "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader"]
