"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py``: ``do_checkpoint`` and
``module_checkpoint`` (``:18-39``), ``Speedometer``,
``log_train_metric`` and ``ProgressBar``, with the same cadence and
output.
"""

from __future__ import annotations

import logging
import math
import sys
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "ProgressBar", "module_checkpoint"]


def do_checkpoint(prefix, period=1):
    """An epoch-end callback: ``model.save_checkpoint(prefix, epoch + 1,
    ...)`` every ``period`` epochs (parameters and symbol; no optimizer
    state)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint

            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """An epoch-end callback: ``mod.save_checkpoint(prefix, epoch + 1,
    save_optimizer_states)`` every ``period`` epochs."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)

    return _callback


def log_train_metric(period, auto_reset=False):
    """Log the metric every ``period`` batches."""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Log samples/sec every ``frequent`` batches.

    The first call after construction, or after the batch counter
    rewinds at an epoch boundary, only opens the timing window.  After
    that a report fires whenever ``nbatch`` is a multiple of
    ``frequent``, rating the ``frequent * batch_size`` samples of the
    window just closed.  ``auto_reset=True`` resets the metric at each
    report; ``False`` lets it accumulate over the epoch."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._window_open_t = None  # None: no window yet (epoch start)
        self._prev_nbatch = 0

    def __call__(self, param):
        nbatch = param.nbatch
        if nbatch < self._prev_nbatch:
            self._window_open_t = None  # counter rewound: new epoch
        self._prev_nbatch = nbatch
        if self._window_open_t is None:
            self._window_open_t = time.time()
            return
        if nbatch % self.frequent:
            return
        elapsed = time.time() - self._window_open_t
        rate = self.frequent * self.batch_size / max(elapsed, 1e-12)
        metric = getattr(param, "eval_metric", None)
        if metric is None:
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, nbatch, rate)
        else:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            for name, value in pairs:
                logging.info(
                    "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    "\tTrain-%s=%f", param.epoch, nbatch, rate, name, value)
        self._window_open_t = time.time()


class ProgressBar:
    """ASCII progress bar over ``total`` batches: ``[=====-----] 50%``."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        filled = int(round(self.bar_len * frac))
        cells = ("=" if i < filled else "-" for i in range(self.bar_len))
        sys.stdout.write("[%s] %d%%\r" % ("".join(cells),
                                         math.ceil(100.0 * frac)))
