"""gluon.data (``mxnet_tpu/gluon/data``): datasets, samplers and the
DataLoader. ``gluon.data.vision`` and ``RecordFileDataset`` wait: they
read files the repo does not hold."""
from . import dataset, sampler, dataloader  # noqa: F401
from .dataset import ArrayDataset, Dataset, SimpleDataset  # noqa: F401
from .sampler import (BatchSampler, RandomSampler, Sampler,  # noqa: F401
                      SequentialSampler)
from .dataloader import DataLoader  # noqa: F401

__all__ = ["dataset", "sampler", "dataloader", "Dataset", "ArrayDataset",
           "SimpleDataset", "Sampler", "SequentialSampler", "RandomSampler",
           "BatchSampler", "DataLoader"]
