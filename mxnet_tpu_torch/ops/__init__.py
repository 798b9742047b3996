"""Ops of the PyTorch port (counterpart of ``mxnet_tpu/ops``).  Importing
the package registers every op the port carries."""

from . import registry
from . import (attention, cuda_kernels, custom, detection, elemwise, indexing,
               matrix, nn, rnn)

__all__ = ["registry", "attention", "cuda_kernels", "custom", "detection",
           "elemwise", "indexing", "matrix", "nn", "rnn"]
