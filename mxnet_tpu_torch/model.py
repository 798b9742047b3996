"""Model checkpoints: ``prefix-symbol.json`` and ``prefix-%04d.params``.

Counterpart of ``mxnet_tpu/model.py:122-191`` (``save_checkpoint``,
``load_checkpoint``), in the same files: the symbol's JSON and an
``nd.save`` dict with ``arg:``/``aux:`` keys, each written atomically,
so either package loads what the other wrote.  Errors name the missing
or corrupt file.  ``FeedForward`` is not ported yet (queue A item 5).
"""

from __future__ import annotations

import logging
import os

from . import ndarray as nd
from . import symbol as sym_mod
from .base import MXNetError
from .checkpoint import atomic_save

__all__ = ["save_checkpoint", "load_checkpoint"]


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
