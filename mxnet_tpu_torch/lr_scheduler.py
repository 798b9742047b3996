"""Learning-rate schedulers.

The port's own copy of ``mxnet_tpu/lr_scheduler.py`` (pure Python: the
port imports nothing of the JAX package): ``LRScheduler``,
``FactorScheduler`` and ``MultiFactorScheduler`` (reference:
``python/mxnet/lr_scheduler.py``).  A scheduler maps ``num_update`` →
lr, mutating ``base_lr`` as decay boundaries are crossed, so an
external rebase of ``base_lr`` (the optimizer writes it at
construction) restarts the decay chain from the current position.
"""

from __future__ import annotations

import logging

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler"]


class LRScheduler:
    """Base: maps num_update → lr (reference: lr_scheduler.py:8)."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update: int) -> float:
        raise NotImplementedError("must override this")


class FactorScheduler(LRScheduler):
    """lr *= factor once per ``step`` updates, floored at
    ``stop_factor_lr`` (reference: lr_scheduler.py:33).

    A decay fires the first time ``num_update`` strictly exceeds
    ``count + step``; ``count`` then advances by ``step``.  Calls are
    lazy — one call may apply several overdue decays at once.
    """

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError(
                f"FactorScheduler: step must be a positive update count, "
                f"got {step}")
        if factor > 1.0:
            raise ValueError(
                f"FactorScheduler: factor {factor} > 1 would GROW the lr; "
                f"use a factor in (0, 1]")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0

    def __call__(self, num_update):
        # boundaries crossed since the last applied decay: each window
        # of `step` updates past `count` owes one multiplication
        overdue = max(0, num_update - self.count - 1) // self.step
        for _ in range(overdue):
            self.count += self.step
            decayed = self.base_lr * self.factor
            if decayed < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                logging.info(
                    "update %d: lr hit the stop_factor_lr floor %.5e; "
                    "no further decay", num_update, self.base_lr)
            else:
                self.base_lr = decayed
                logging.info("update %d: lr decayed to %.5e",
                             num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """lr *= factor as each milestone in ``step`` is passed
    (reference: lr_scheduler.py:83).  A milestone ``s`` fires the first
    time ``num_update`` strictly exceeds ``s``; like FactorScheduler,
    several overdue milestones apply in one call."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not (isinstance(step, list) and step):
            raise ValueError("MultiFactorScheduler: step must be a "
                             "non-empty list of update milestones")
        for i, s in enumerate(step):
            if s < 1:
                raise ValueError(
                    f"MultiFactorScheduler: milestone {s} is not a "
                    f"positive update count")
            if i and s <= step[i - 1]:
                raise ValueError(
                    f"MultiFactorScheduler: milestones must be strictly "
                    f"increasing, got {step[i - 1]} before {s}")
        if factor > 1.0:
            raise ValueError(
                f"MultiFactorScheduler: factor {factor} > 1 would GROW "
                f"the lr; use a factor in (0, 1]")
        self.step = step
        self.cur_step_ind = 0
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while self.cur_step_ind < len(self.step) \
                and num_update > self.step[self.cur_step_ind]:
            self.count = self.step[self.cur_step_ind]
            self.cur_step_ind += 1
            self.base_lr *= self.factor
            logging.info("update %d: lr decayed to %.5e (milestone %d)",
                         num_update, self.base_lr, self.count)
        return self.base_lr
