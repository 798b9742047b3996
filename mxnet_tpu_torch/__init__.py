"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX reference, written for an NVIDIA H100.
This slice serves the ``transformer_lm`` family through
:class:`DecodeEngine`, on two hand-written CUDA kernels (packed-QKV
flash prefill and paged decode attention, ``csrc/``).  It imports
``torch``, never ``jax`` and nothing of ``mxnet_tpu``.

Entry points run on the card (``gpu(0)``) unless the caller passes
``ctx=cpu()``; there the kernels' plain PyTorch versions run.
"""

from .base import MXNetError
from .context import Context, cpu, current_context, gpu
from .convert import params_from_numpy
from .serving import DecodeEngine, EngineClosedError

__all__ = ["DecodeEngine", "EngineClosedError", "MXNetError", "Context",
           "cpu", "gpu", "current_context", "params_from_numpy"]
