"""Ops of the PyTorch port (counterpart of ``mxnet_tpu/ops``).  Importing
the package registers every op the port carries."""

from . import registry
from . import (adapter, attention, cuda_kernels, custom, detection,
               elemwise, indexing, init_ops, matrix, nn, optimizer_op,
               ordering, reduce, rnn, sample, spatial)

__all__ = ["registry", "adapter", "attention", "cuda_kernels", "custom",
           "detection", "elemwise", "indexing", "init_ops", "matrix", "nn",
           "optimizer_op", "ordering", "reduce", "rnn", "sample", "spatial"]
