"""BucketingModule — variable-length training with one Module per bucket.

Counterpart of ``mxnet_tpu/module/bucketing_module.py``: a
``sym_gen(bucket_key) -> (symbol, data_names, label_names)`` factory,
one ``Module`` per bucket key met, all bound with ``shared_module`` to
the default bucket's, so every bucket's parameters and gradients are
the same NDArray objects, and all sharing one optimizer and updater, so
Adam's moments and step counts carry across buckets.  Under the fused
step the bucket switched to takes over the previous bucket's fused
state (``Module._adopt_fused_state``, the JAX package's
``_adopt_fused_state``): one set of optimizer states, one device step
counter ``t`` and one set of random streams for every bucket, and one
CUDA graph pool for every bucket's graphs (``bind`` with
``shared_module``).  The context defaults to ``gpu(0)`` and is resolved
at construction.  A checkpoint holds the default bucket's symbol and
the shared parameters; its optimizer state goes through the current
bucket, which holds the adopted fused state
(``mxnet_tpu/module/bucketing_module.py:219-236``).  A monitor
installed with ``install_monitor`` taps every bucket's executor, those
of buckets bound later too (``:204-217``).
"""

from __future__ import annotations

import logging

from ..base import MXNetError
from ..checkpoint import atomic_save
from ..context import Context, current_context
from ..initializer import Uniform
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("BucketingModule needs a default_bucket_key")
        if context is None:
            context = current_context()
        if isinstance(context, Context):
            context.torch_device()  # a gpu context without CUDA raises here
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._monitor = None

    def _reset_bind(self):
        self.binded = False
        self.optimizer_initialized = False  # the rebound modules need one
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    def _gen_module(self, bucket_key):
        symbol, data_names, label_names = self._sym_gen(bucket_key)
        return Module(symbol, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      work_load_list=self._work_load_list,
                      fixed_param_names=self._fixed_param_names)

    # -- properties ----------------------------------------------------------
    @property
    def data_names(self):
        if self.binded:
            return self._curr_module.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._curr_module.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    @property
    def data_shapes(self):
        self._check_binded()
        return self._curr_module.data_shapes

    @property
    def label_shapes(self):
        self._check_binded()
        return self._curr_module.label_shapes

    @property
    def output_shapes(self):
        self._check_binded()
        return self._curr_module.output_shapes

    @property
    def symbol(self):
        self._check_binded()
        return self._curr_module.symbol

    def _check_binded(self):
        if not self.binded:
            raise MXNetError("call bind first")

    def _check_ready(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("the module needs bind() and init_params()")

    # -- parameters ----------------------------------------------------------
    def get_params(self):
        self._check_ready()
        return self._curr_module.get_params()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        self._check_binded()
        self._curr_module.init_params(initializer=initializer,
                                      arg_params=arg_params,
                                      aux_params=aux_params,
                                      allow_missing=allow_missing,
                                      force_init=force_init)
        self.params_initialized = True

    # -- binding -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        """Bind the default bucket's module; ``force_rebind`` keeps the
        parameters' values."""
        if shared_module is not None:
            raise MXNetError("shared_module for BucketingModule is not "
                             "supported")
        saved_params = None
        if force_rebind:
            if self.binded and self.params_initialized:
                saved_params = self.get_params()
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already binded, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        module = self._gen_module(self._default_bucket_key)
        module.bind(data_shapes, label_shapes, for_training, inputs_need_grad,
                    grad_req=grad_req)
        self._curr_module = module
        self._curr_bucket_key = self._default_bucket_key
        self._buckets[self._default_bucket_key] = module
        self.binded = True
        if saved_params is not None:
            module.set_params(*saved_params)
        else:
            self.params_initialized = False

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` the active bucket, binding its module
        against the shared parameters on first sight."""
        self._check_binded()
        if bucket_key not in self._buckets:
            module = self._gen_module(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._curr_module.for_training,
                        self._curr_module.inputs_need_grad,
                        shared_module=self._buckets[self._default_bucket_key],
                        grad_req=self._grad_req)
            if self._monitor is not None:
                module.install_monitor(self._monitor)
            self._buckets[bucket_key] = module
        if bucket_key != self._curr_bucket_key:
            prev = self._curr_module
            module = self._buckets[bucket_key]
            if prev.optimizer_initialized and not module.optimizer_initialized:
                module.borrow_optimizer(prev)
            if prev.optimizer_initialized:
                module._adopt_fused_state(prev)
            self._curr_module = module
            self._curr_bucket_key = bucket_key

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._check_ready()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init=force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module:
                mod.borrow_optimizer(self._curr_module)
        self.optimizer_initialized = True

    # -- computation ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        """Switch to the batch's ``bucket_key`` (the current bucket when
        it has none), then run that bucket's module."""
        self._check_ready()
        bucket_key = getattr(data_batch, "bucket_key", None)
        if bucket_key is None:
            bucket_key = self._curr_bucket_key
        self.switch_bucket(bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._check_ready()
        self._curr_module.backward(out_grads=out_grads)

    def update(self):
        self._check_ready()
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer before update")
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        self._check_ready()
        return self._curr_module.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._check_ready()
        if not self.inputs_need_grad:
            raise MXNetError("get_input_grads needs bind(inputs_need_grad="
                             "True)")
        return self._curr_module.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._check_ready()
        self._curr_module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """``mon`` on every bucket's executor, and on each bucket bound
        later."""
        self._check_binded()
        self._monitor = mon
        for mod in self._buckets.values():
            mod.install_monitor(mon)

    def graph_stats(self):
        """``Module.graph_stats`` summed over the bucket modules."""
        stats = [m.graph_stats() for m in self._buckets.values()]
        out = {"graphs_on": all(s["graphs_on"] for s in stats),
               "uncapturable_ops": sorted({o for s in stats
                                           for o in s["uncapturable_ops"]})}
        for k in ("graphs", "captures", "capture_ms", "pool_bytes"):
            out[k] = sum(s[k] for s in stats)
        return out

    # -- checkpoints ---------------------------------------------------------
    def _optimizer_states_to_host(self, lazy=False):
        self._check_ready()
        return self._curr_module._optimizer_states_to_host(lazy=lazy)

    def _install_optimizer_states(self, payload):
        self._check_ready()
        self._curr_module._install_optimizer_states(payload)

    def save_optimizer_states(self, fname):
        self._check_ready()
        self._curr_module.save_optimizer_states(fname)

    def load_optimizer_states(self, fname):
        self._check_ready()
        self._curr_module.load_optimizer_states(fname)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """The default bucket's symbol and the shared parameters (and
        with ``save_optimizer_states`` the optimizer states)."""
        atomic_save(f"{prefix}-symbol.json",
                    self._buckets[self._default_bucket_key]._symbol.save)
        self.save_params("%s-%04d.params" % (prefix, epoch))
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))
