"""Vision datasets and transforms (``mxnet_tpu/gluon/data/vision``)."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,  # noqa: F401
                       ImageRecordDataset, ImageFolderDataset)
from . import transforms  # noqa: F401

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "ImageFolderDataset", "transforms"]
