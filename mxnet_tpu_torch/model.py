"""Model checkpoints: ``prefix-symbol.json`` and ``prefix-%04d.params``.

Counterpart of ``mxnet_tpu/model.py:122-191`` (``save_checkpoint``,
``load_checkpoint``), in the same files: the symbol's JSON and an
``nd.save`` dict with ``arg:``/``aux:`` keys, each written atomically,
so either package loads what the other wrote.  Errors name the missing
or corrupt file.

``FeedForward`` (``:194-292``) is the classic scikit-style training API
over one context, a thin adapter over ``Module``: ``fit``, ``predict``,
``score``, ``save``, ``load`` and ``create``.  A kvstore other than
``None``/``'local'`` raises (distribution is queue A item 9).
"""

from __future__ import annotations

import logging
import os

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError, not_ported
from .checkpoint import atomic_save
from .ndarray import NDArray

__all__ = ["save_checkpoint", "load_checkpoint", "FeedForward"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``, each crash-safely (a temporary file, fsync,
    rename)."""
    if symbol is not None:
        atomic_save(f"{prefix}-symbol.json", symbol.save)
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    atomic_save(param_name, lambda tmp: nd.save(tmp, save_dict))
    logging.info('Saved checkpoint to "%s"', param_name)


def _load_checkpoint_file(path, what, loader):
    if not os.path.exists(path):
        raise MXNetError(f"load_checkpoint: missing {what} file {path!r}")
    try:
        return loader(path)
    except MXNetError as exc:
        if path in str(exc):
            raise
        raise MXNetError(f"load_checkpoint: {what} file {path!r}: {exc}")
    except Exception as exc:
        raise MXNetError(
            f"load_checkpoint: corrupt or truncated {what} file {path!r}: "
            f"{exc}")


def split_params(save_dict):
    """``arg:``/``aux:`` keys → (arg_params, aux_params)."""
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
        else:
            raise MXNetError(f"invalid parameter key {k!r}")
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) of ``save_checkpoint``'s files;
    the arrays are NDArrays on the CPU."""
    symbol = _load_checkpoint_file(f"{prefix}-symbol.json", "symbol",
                                   sym_mod.load)
    param_path = "%s-%04d.params" % (prefix, epoch)

    def load_params(path):
        d = nd.load(path)
        if not isinstance(d, dict):
            raise MXNetError("params file holds a list, not a name->array "
                             "dict")
        return split_params(d)

    arg_params, aux_params = _load_checkpoint_file(param_path, "params",
                                                   load_params)
    return symbol, arg_params, aux_params


def _check_kvstore(kvstore):
    if kvstore not in (None, "local"):
        raise not_ported(f"FeedForward over kvstore {kvstore!r} "
                         f"(distribution, queue A item 9)")


class FeedForward:
    """A symbol trained and run on one context (``ctx``, default
    ``gpu(0)``) through a ``Module``: ``optimizer`` by name with the
    remaining keyword arguments as its parameters, ``initializer``
    (default ``Uniform(0.01)``), numpy inputs batched by
    ``numpy_batch_size``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform

        if isinstance(ctx, (list, tuple)):
            if len(ctx) != 1:
                raise not_ported("FeedForward over several contexts "
                                 "(queue A item 9)")
            ctx = ctx[0]
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer if initializer is not None \
            else Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs
        self._module = None

    def _get_module(self):
        from .context import gpu
        from .module import Module

        if self._module is None:
            self._module = Module(self.symbol, context=self.ctx or gpu(0))
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train ``num_epoch`` epochs over ``X`` (a DataIter, or arrays
        with labels ``y``); the parameters are kept on the model."""
        _check_kvstore(kvstore)
        train_data = self._as_iter(X, y)
        mod = self._get_module()
        mod.fit(train_data, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=self.kwargs,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch, monitor=monitor,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback)
        self.arg_params, self.aux_params = mod.get_params()

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """The outputs over ``X`` as numpy (one array, or a list for
        several outputs)."""
        data = self._as_iter(X, None)
        mod = self._get_module()
        if not mod.binded:
            mod.bind(data_shapes=data.provide_data, for_training=False)
            mod.init_params(self.initializer, arg_params=self.arg_params,
                            aux_params=self.aux_params)
        outs = mod.predict(data, num_batch=num_batch, reset=reset)
        return outs.asnumpy() if isinstance(outs, NDArray) \
            else [o.asnumpy() for o in outs]

    def score(self, X, y=None, eval_metric="acc", num_batch=None,
              reset=True):
        """``eval_metric``'s value over ``X``."""
        data = self._as_iter(X, y)
        mod = self._get_module()
        if not mod.binded:
            mod.bind(data_shapes=data.provide_data,
                     label_shapes=data.provide_label, for_training=False)
            mod.init_params(self.initializer, arg_params=self.arg_params,
                            aux_params=self.aux_params)
        res = mod.score(data, eval_metric, num_batch=num_batch, reset=reset)
        return res[0][1]

    def _as_iter(self, X, y):
        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size)

    def save(self, prefix, epoch=None):
        """``prefix-symbol.json`` and ``prefix-%04d.params`` (epoch
        ``num_epoch`` by default)."""
        if epoch is None:
            epoch = self.num_epoch or 0
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """A model over ``save``'s files, to go on from ``epoch``."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, **kwargs):
        """A model made and fitted in one call."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list)
        return model
