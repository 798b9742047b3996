"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX reference, written for an NVIDIA H100.
It serves the ``transformer_lm`` family through :class:`DecodeEngine`
(fp32/bf16 or int8/fp8 KV pages, n-gram speculative decoding) and
trains it through ``mod.Module`` over the ``transformer_lm`` symbol or
over user-written ``sym.DotProductAttention`` symbols, trains and
scores the LSTM language model through ``mod.BucketingModule`` over
``sym.RNN``, trains and runs the SSD detector, trains and scores the
image classifiers (LeNet, the MLP, ResNet with ``sym.BatchNorm``'s
moving statistics as aux states; ``examples/train_mnist.py``,
``train_imagenet.py``, ``benchmark_score.py``), and cuts long sequences
over devices (``sequence``: ring and Ulysses attention), on hand-written
CUDA kernels (packed-QKV flash attention forward and backward,
attention over separate q, k, v forward and backward, the partial
online-softmax state of a ring hop forward and backward, paged decode
attention over raw and quantized pages, the speculative verify window,
the LSTM recurrence, greedy NMS; ``csrc/``).  Every registered op is also an
imperative function, ``nd.<op>``.  Users add operators of their own:
``rtc.register_op`` over a torch function, ``rtc.cuda_op`` over a
``__global__`` kernel written in CUDA C++ and built with ``nvcc`` at
first use (the port of ``rtc.pallas_op``; worked example
``examples/user_cuda_kernel.py``), and ``operator.CustomOp`` with
Python forward and backward over NDArrays (``sym.Custom``).  It imports
``torch``, never ``jax`` and nothing of ``mxnet_tpu``.

Entry points run on the card (``gpu(0)``) unless the caller passes
``ctx=cpu()`` (``context=cpu()`` for ``Module``); there the kernels'
plain PyTorch versions run.

Checkpoints use the JAX package's files, so each package loads what the
other wrote: ``nd.save``/``nd.load``, ``sym.load``/``sym.load_json``,
``model.save_checkpoint``/``load_checkpoint``, ``Module.load``/
``save_checkpoint`` with the optimizer states, and
``CheckpointManager`` with ``Module.fit(checkpoint=..., resume='auto')``.

The training surface of the MXNet 0.9 API around them: the optimizers
(SGD, NAG, SGLD, DCASGD, Adam, AdaGrad, RMSProp, AdaDelta), the metrics
and initializers, ``Monitor``, ``model.FeedForward``,
``mod.SequentialModule``/``PythonModule``, ``config`` (the catalog of
the ``MXNET_*`` variables the port reads) and ``engine``.
"""

from .base import MXNetError
from . import config
from . import engine
from . import context
from .context import Context, cpu, current_context, gpu
from .convert import params_from_numpy, params_to_numpy
from . import ndarray
from . import ndarray as nd
from . import random
from .attribute import AttrScope
from . import symbol
from . import symbol as sym
from .symbol import Group, Variable
from . import callback, executor, initializer, io, metric, optimizer
from .executor import Executor
from .initializer import Normal, Uniform, Xavier
from . import lr_scheduler
from . import checkpoint
from .checkpoint import CheckpointManager
from . import model
from . import module
from . import module as mod
from . import models
from . import speculative
from . import operator, rtc
from . import sequence
from . import monitor
from .monitor import Monitor
from .serving import DecodeEngine, EngineClosedError

__all__ = ["DecodeEngine", "EngineClosedError", "MXNetError", "Context",
           "cpu", "gpu", "current_context", "context", "config", "engine",
           "executor", "Executor", "Monitor", "monitor", "Uniform",
           "Normal", "Xavier", "params_from_numpy",
           "params_to_numpy", "nd", "sym", "mod", "io", "metric", "callback",
           "optimizer", "lr_scheduler", "initializer", "random", "models",
           "speculative", "operator", "rtc", "sequence", "Variable", "Group",
           "AttrScope", "checkpoint", "CheckpointManager", "model"]
