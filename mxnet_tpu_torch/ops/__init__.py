"""Ops of the PyTorch port (counterpart of ``mxnet_tpu/ops``)."""

from . import attention, cuda_kernels, indexing, nn

__all__ = ["attention", "cuda_kernels", "indexing", "nn"]
