"""Module API (counterpart of ``mxnet_tpu/module``): single-device
``Module`` training and scoring, ``BucketingModule`` over it,
``SequentialModule`` chains and ``PythonModule``/``PythonLossModule``
written in host code."""

from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule", "Module",
           "SequentialModule", "PythonModule", "PythonLossModule"]
