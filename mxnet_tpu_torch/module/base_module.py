"""BaseModule — the training-loop state machine.

Counterpart of ``mxnet_tpu/module/base_module.py``: the bind →
init_params → init_optimizer lifecycle plus ``forward_backward``
(``:41-43``), ``score``, ``iter_predict`` and ``predict``
(``:74-115``), ``fit`` (``:117``) with a ``checkpoint.
CheckpointManager`` and ``resume`` (``:160-214``), and
``save_params``/``load_params``.  ``fit(monitor=)`` installs the
``Monitor`` and brackets each batch with ``tic``/``toc_print``
(``:183-184``, ``:263-264``, ``:320-321``).  Elastic mode is not ported
yet and raises.
"""

from __future__ import annotations

import logging
import time
from collections import namedtuple

from .. import metric as metric_mod
from .. import ndarray as nd
from ..base import MXNetError, get_env, not_ported

__all__ = ["BaseModule", "BatchEndParam"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- high-level interface ------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate ``eval_metric`` over ``eval_data`` → [(name, value)]."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("score needs a bound module with parameters")
        if reset:
            eval_data.reset()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        actual_num_batch = 0
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                       eval_metric=eval_metric,
                                       locals=locals())
                for callback in _as_list(batch_end_callback):
                    callback(params)
            actual_num_batch += 1
        if score_end_callback:
            params = BatchEndParam(epoch=epoch, nbatch=actual_num_batch,
                                   eval_metric=eval_metric, locals=locals())
            for callback in _as_list(score_end_callback):
                callback(params)
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Yield (outputs, nbatch, batch) for each batch of ``eval_data``
        run with ``is_train=False``, the outputs cut by the batch's pad
        (views of the module's outputs, valid until the next forward)."""
        if not (self.binded and self.params_initialized):
            raise RuntimeError("iter_predict needs a bound module with "
                               "parameters")
        if reset:
            eval_data.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outputs = [out[0:out.shape[0] - pad]
                       for out in self.get_outputs()]
            yield (outputs, nbatch, eval_batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """The outputs over ``eval_data`` (``is_train=False``), each
        batch's cut by its pad: with ``merge_batches`` one array per
        output, concatenated over the batches (the array itself for a
        single output unless ``always_output_list``), else a list of
        each batch's outputs."""
        output_list = [[out.copy() for out in outputs]
                       for outputs, _, _ in self.iter_predict(
                           eval_data, num_batch=num_batch, reset=reset)]
        if not (output_list and merge_batches):
            return output_list
        num_outputs = len(output_list[0])
        if any(len(out) != num_outputs for out in output_list):
            raise MXNetError("Cannot merge batches, as num of outputs is "
                             "not the same in mini-batches. Maybe bucketing "
                             "is used?")
        merged = [nd.concatenate([out[i] for out in output_list])
                  for i in range(num_outputs)]
        if num_outputs == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, checkpoint=None, resume=None, elastic_data=None):
        """Train ``num_epoch`` epochs over ``train_data``: per batch
        ``forward_backward`` + ``update`` + metric; per epoch the
        callbacks and, with ``eval_data``, a ``score`` pass.

        ``checkpoint`` (a ``checkpoint.CheckpointManager``; made over
        ``MXNET_CKPT_DIR`` when that is set and none is given) saves the
        training state on its ``every_n_steps`` cadence and on SIGTERM.
        ``resume='auto'`` (or True) restores its newest committed
        checkpoint: parameters, optimizer state, randomness, epoch,
        batch and the iterator's position, and goes on as if never
        stopped; ``'never'``, False or None start afresh."""
        if num_epoch is None:
            raise ValueError("please specify number of epochs")
        if elastic_data not in (None, False):
            raise not_ported("fit(elastic_data=...) (queue A item 9)")
        from ..initializer import Uniform

        if initializer is None:
            initializer = Uniform(0.01)
        if checkpoint is None:
            ckpt_dir = get_env("MXNET_CKPT_DIR", None, str)
            if ckpt_dir:
                from ..checkpoint import CheckpointManager

                checkpoint = CheckpointManager(ckpt_dir, logger=self.logger)
        if resume not in (None, False, True, "auto", "never"):
            raise MXNetError(f"fit: resume must be 'auto'/'never'/bool, "
                             f"got {resume!r}")
        ckpt_state = None
        if resume in (True, "auto"):
            if checkpoint is None:
                raise MXNetError("fit(resume='auto') needs a checkpoint "
                                 "manager (or MXNET_CKPT_DIR)")
            ckpt_state = checkpoint.load_latest()
            if ckpt_state is not None:
                arg_params = ckpt_state["arg_params"]
                aux_params = ckpt_state["aux_params"]
                begin_epoch = ckpt_state["epoch"]
                force_init = True

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        resume_nbatch = -1
        if checkpoint is not None:
            checkpoint.attach(self, train_data)
            checkpoint.install_signal_handler()
            if ckpt_state is not None:
                checkpoint.restore_training_state(self, ckpt_state,
                                                  train_data)
                resume_nbatch = ckpt_state["nbatch"]
        if validation_metric is None:
            validation_metric = eval_metric
        eval_metric = metric_mod.create(eval_metric)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            if resume_nbatch >= 0:
                # the restored iterator goes on after the checkpointed
                # batch; so does the count
                nbatch, resume_nbatch = resume_nbatch + 1, -1
            for data_batch in train_data:
                if monitor is not None:
                    monitor.tic()
                if checkpoint is not None:
                    checkpoint.step_begin()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if checkpoint is not None:
                    checkpoint.step_end(self, epoch=epoch, nbatch=nbatch,
                                        train_iter=train_data)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    params = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                           eval_metric=eval_metric,
                                           locals=locals())
                    for callback in _as_list(batch_end_callback):
                        callback(params)
                nbatch += 1
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - tic)
            if epoch_end_callback is not None:
                arg_params_, aux_params_ = self.get_params()
                for callback in _as_list(epoch_end_callback):
                    callback(epoch, self.symbol, arg_params_, aux_params_)
            if eval_data:
                res = self.score(eval_data, validation_metric,
                                 score_end_callback=eval_end_callback,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()
        if checkpoint is not None:
            # the queued saves land before the caller can exit
            checkpoint.flush()

    # -- symbol & params -------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    def save_params(self, fname):
        """The parameters as an ``nd.save`` dict with ``arg:``/``aux:``
        keys, written atomically."""
        from ..checkpoint import atomic_save

        arg_params, aux_params = self.get_params()
        save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
        save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
        atomic_save(fname, lambda tmp: nd.save(tmp, save_dict))

    def load_params(self, fname):
        """``save_params``' file (either package's) into the parameters,
        in place."""
        from ..model import split_params

        self.set_params(*split_params(nd.load(fname)))

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()
