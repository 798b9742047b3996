"""SequentialModule: modules chained head to tail.

Counterpart of ``mxnet_tpu/module/sequential_module.py:21``: each added
module takes the previous module's outputs as its data (renamed to its
own data names with ``auto_wiring``), the labels go only to modules
added with ``take_labels``, and the backward hands each module's input
gradients to the module before it as its head gradients.  Every module
after the first binds with ``inputs_need_grad``, so it trains on the
eager path (``Module._fused_ready``).
"""

from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from ..io import DataBatch
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Append ``module``; ``kwargs``: ``take_labels``,
        ``auto_wiring``.  Returns self, so calls chain."""
        for key in kwargs:
            if key not in self._meta_keys:
                raise MXNetError(f"Unknown meta {key!r}: one of "
                                 f"{sorted(self._meta_keys)}")
        self._modules.append(module)
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _check(self, bound=True, params=True, optimizer=False):
        if bound and not self.binded:
            raise MXNetError("SequentialModule needs bind()")
        if params and not self.params_initialized:
            raise MXNetError("SequentialModule needs init_params()")
        if optimizer and not self.optimizer_initialized:
            raise MXNetError("SequentialModule needs init_optimizer()")

    @property
    def data_names(self):
        return self._modules[0].data_names if self._modules else []

    @property
    def output_names(self):
        return self._modules[-1].output_names if self._modules else []

    @property
    def data_shapes(self):
        self._check(params=False)
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        self._check(params=False)
        return self._label_shapes

    @property
    def output_shapes(self):
        self._check(params=False)
        return self._modules[-1].output_shapes

    def get_params(self):
        self._check()
        arg_params, aux_params = {}, {}
        for module in self._modules:
            arg, aux = module.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        """Each module's parameters; a name in two modules raises."""
        if self.params_initialized and not force_init:
            return
        self._check(params=False)
        for module in self._modules:
            module.init_params(initializer=initializer, arg_params=arg_params,
                               aux_params=aux_params,
                               allow_missing=allow_missing,
                               force_init=force_init)
        arg_names, aux_names = {}, {}
        for i, module in enumerate(self._modules):
            arg, aux = module.get_params()
            for known, new in ((arg_names, arg), (aux_names, aux)):
                for name in new:
                    if name in known:
                        raise MXNetError(
                            f"Duplicate parameter names: {name!r} in layer "
                            f"{i} ({type(module).__name__}) and layer "
                            f"{known[name]}")
                    known[name] = i
        self.params_initialized = True

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already binded, ignoring bind()")
            return
        if not self._modules:
            raise MXNetError("SequentialModule has no module to bind")
        if shared_module is not None:
            raise MXNetError("Shared module is not supported for "
                             "SequentialModule")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._label_shapes = ([(d[0], tuple(d[1])) for d in label_shapes]
                              if label_shapes else None)
        my_data_shapes = [(d[0], tuple(d[1])) for d in data_shapes]
        anybody_ever_needs_label = False
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            if meta.get(self.META_TAKE_LABELS, False):
                my_label_shapes = self._label_shapes
                anybody_ever_needs_label = True
            else:
                my_label_shapes = None
            if meta.get(self.META_AUTO_WIRING, False):
                data_names = module.data_names
                if len(data_names) != len(my_data_shapes):
                    raise MXNetError(
                        f"auto_wiring: layer {i} takes {data_names}, the "
                        f"layer before gives {len(my_data_shapes)} outputs")
                my_data_shapes = [(new, shape) for new, (_, shape)
                                  in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=for_training and (inputs_need_grad
                                                           or i > 0),
                        force_rebind=force_rebind, shared_module=None,
                        grad_req=grad_req)
            my_data_shapes = module.output_shapes
        if not anybody_ever_needs_label:
            self._label_shapes = None
        self.binded = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._check()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for module in self._modules:
            module.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                                  optimizer_params=optimizer_params,
                                  force_init=force_init)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._check()
        batch = DataBatch(list(data_batch.data), data_batch.label,
                          pad=data_batch.pad, index=data_batch.index,
                          provide_data=data_batch.provide_data,
                          provide_label=data_batch.provide_label)
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i + 1 < len(self._modules):
                batch.data = module.get_outputs()
                batch.provide_data = [
                    (name, out.shape) for name, out in
                    zip(module.output_names, batch.data)]

    def backward(self, out_grads=None):
        self._check()
        for i in range(len(self._modules) - 1, -1, -1):
            module = self._modules[i]
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        self._check(optimizer=True)
        for module in self._modules:
            module.update()

    def get_outputs(self, merge_multi_context=True):
        self._check()
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._check()
        if not self.inputs_need_grad:
            raise MXNetError("get_input_grads needs bind(inputs_need_grad="
                             "True)")
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._check()
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._check(params=False)
        for module in self._modules:
            module.install_monitor(mon)
