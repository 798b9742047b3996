"""PythonModule and PythonLossModule: modules written in host code.

Counterpart of ``mxnet_tpu/module/python_module.py:24, 97``: a
``BaseModule`` without parameters whose forward and backward the user
writes in Python, glue for custom training loops and
``SequentialModule`` chains (the device-side equivalent is a
``CustomOp``).  ``PythonLossModule`` passes its scores through and takes
their gradient from ``grad_func(scores, labels)``.
"""

from __future__ import annotations

import logging

import numpy as np

from .. import ndarray as nd
from ..base import MXNetError
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Subclasses give ``_compute_output_shapes``, ``forward``,
    ``backward``, ``get_outputs`` and ``get_input_grads``."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_shapes(self):
        return self._output_shapes

    def get_params(self):
        return ({}, {})

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        self.params_initialized = True

    def update(self):
        pass

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._data_shapes = [(d[0], tuple(d[1])) for d in data_shapes]
        self._label_shapes = ([(d[0], tuple(d[1])) for d in label_shapes]
                              if label_shapes else None)
        self._output_shapes = self._compute_output_shapes()

    def _compute_output_shapes(self):
        raise NotImplementedError()

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A loss in host code: the forward passes the scores through, the
    backward's input gradient is ``grad_func(scores, labels)`` (an
    NDArray, or an array made one on the scores' context)."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        if len(self._data_names) != 1:
            raise MXNetError("PythonLossModule takes one data input")
        self._scores = None
        self._labels = None
        self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise MXNetError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train is None:
            is_train = self.for_training
        if is_train and data_batch.label:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise MXNetError("For a loss module, out_grads is ignored")
        if not self.for_training:
            raise MXNetError("backward needs bind(for_training=True)")
        if self._grad_func is None:
            raise MXNetError("PythonLossModule requires a grad_func to "
                             "compute gradients")
        grad = self._grad_func(self._scores, self._labels)
        if not isinstance(grad, nd.NDArray):
            grad = nd.array(np.asarray(grad), ctx=self._scores.context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
