"""Module API (counterpart of ``mxnet_tpu/module``): single-device
``Module`` training and scoring, and ``BucketingModule`` over it."""

from .base_module import BaseModule, BatchEndParam
from .bucketing_module import BucketingModule
from .module import Module

__all__ = ["BaseModule", "BatchEndParam", "BucketingModule", "Module"]
