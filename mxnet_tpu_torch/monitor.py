"""Monitor: statistics of every op output, weight and aux state, for
debugging (NaN hunting, blow-ups).

Counterpart of ``mxnet_tpu/monitor.py:26``.  ``install`` taps an
executor (``Executor.set_monitor_callback``): while a batch is collected
(``tic`` of every ``interval``-th batch), each forward hands every
node's output, by the name ``get_internals().list_outputs()`` gives it,
to ``stat_func``; ``toc`` adds each argument and aux state of the
executors, then reads the statistics back and returns ``[(step, name,
value string)]``.  The default statistic is |x|_2 / sqrt(size), computed
where the array lies (``nd.norm``); the statistics stay on the device
until ``toc``.  A monitored ``Module`` trains on the eager path, where
the executor's forward runs (``Module._fused_ready``).
"""

from __future__ import annotations

import logging
import re
from math import sqrt

from . import ndarray
from .ndarray import NDArray

__all__ = ["Monitor"]


class Monitor:
    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                """|x|_2 / sqrt(size)."""
                return ndarray.norm(x) / sqrt(x.size)
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, array):
            if not self.activated or not self.re_prog.match(name):
                return
            self.queue.append((self.step, name, self.stat_func(array)))
        self.stat_helper = stat_helper

    def install(self, exe):
        """Tap ``exe`` (several executors may share one monitor)."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Start collecting for this batch; call before forward."""
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting: the arguments' and aux states' statistics
        join the outputs', each read back → [(step, name, value
        string)]."""
        if not self.activated:
            return []
        for exe in self.exes:
            for name, array in zip(exe._symbol.list_arguments(),
                                   exe.arg_arrays):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
            for name, array in zip(exe._symbol.list_auxiliary_states(),
                                   exe.aux_arrays):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if isinstance(v_list, NDArray):
                v_list = [v_list]
            if not isinstance(v_list, list):
                raise TypeError(f"stat_func gave {type(v_list)}, not an "
                                "NDArray or a list of them")
            s = ""
            for v in v_list:
                if v.size == 1:
                    s += str(v.asscalar()) + "\t"
                else:
                    s += str(v.asnumpy()) + "\t"
            res.append((n, k, s))
        self.queue = []
        return res

    def toc_print(self):
        """Stop collecting and log the results."""
        for n, k, v in self.toc():
            logging.info("Batch: %7d %30s %s", n, k, v)
