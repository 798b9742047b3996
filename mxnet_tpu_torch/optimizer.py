"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py``: ``Optimizer`` (rescale,
clip, the ``wd_mult`` name rule, ``lr_mult``, update counts;
``:48-160``), ``SGD`` with momentum (``:188-215``), ``Adam``
(``:303-336``), ``create`` and ``get_updater``.

The functional core is the port of ``init_state_arrays`` and ``apply``
(``:122-128``), written over lists: ``init_state_arrays(weights)`` makes
one state a weight, and ``apply(weights, grads, states, lr, wd, t)``
updates every weight and state of the lists in place with multi-tensor
ops (``torch._foreach_*``: a few launches for all of them on the card).
The Module's fused step calls it once per (lr_mult, wd_mult) group with
``lr`` and ``t`` as 0-dim float64 device tensors, so a captured step
reads them from the device.  The per-parameter ``Updater`` (the eager
path) calls ``update``, whose ``_step`` runs the same operations on one
tensor with Python numbers, without the lists.  In-place writes keep
each weight's and state's dtype (the JAX segment's ``astype``); the
learning rate and Adam's bias correction are float64 (Python's, or the
tensors'), cast once to the weights' type.  The arithmetic follows the
reference's ``apply`` term by term.

A bfloat16 or float16 weight is updated with no master copy, as the
JAX fused step has none (``mxnet_tpu/module/module.py:1348-1360``):
every term is formed in float32 from the gradient's, weight's and
states' values, and the new weight and states are rounded once into
their dtypes.  (The JAX step rounds the terms without the rate to the
weight's dtype on the way; the two agree within those roundings.)  One
body serves every dtype: it works on float32 copies of the half-precision
tensors (``_widen``: a float32 or float64 tensor is its own) and writes
back only the copies (``_narrow_into``), in ``apply`` and ``_step``
alike, and a list may mix dtypes.  Every product with a Python number
is taken in float32 or float64, where a multi-tensor op and a tensor's
own op round alike (on the CPU, ``torch._foreach_mul_`` rounds the
number to a bf16 list's dtype first and ``mul_`` does not).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .base import Registry
from .ndarray import NDArray, tensor_from_numpy

__all__ = ["Optimizer", "SGD", "Adam", "Updater", "get_updater", "create",
           "register", "place_state"]

_REGISTRY = Registry("optimizer")


def register(klass):
    _REGISTRY.register(klass.__name__, klass)
    return klass


def create(name, **kwargs) -> "Optimizer":
    return _REGISTRY.get(name)(**kwargs)


class Optimizer:
    """Base optimizer: learning rate, weight decay and their per-name
    multipliers, gradient rescale and clip, update counts."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[Any, int] = {}
        self.idx2name = dict(param_idx2name or {})
        self.sym = sym
        self.lr_mult: Dict[str, float] = {}
        self.wd_mult: Dict[str, float] = {}
        # name-rule defaults (params not ending in _weight/_gamma get
        # wd_mult 0), then the symbol's lr_mult/wd_mult attrs
        self.set_lr_mult({})
        self.set_wd_mult({})
        if sym is not None:
            attrs = sym.attr_dict()
            for name in sym.list_arguments():
                if name in attrs:
                    if "lr_mult" in attrs[name]:
                        self.lr_mult[name] = float(attrs[name]["lr_mult"])
                    if "wd_mult" in attrs[name]:
                        self.wd_mult[name] = float(attrs[name]["wd_mult"])

    def set_lr_mult(self, args_lr_mult: Dict[str, float]):
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult: Dict[str, float]):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _name(self, index):
        return self.idx2name.get(index, index if isinstance(index, str)
                                 else None)

    def _get_lr(self, index) -> float:
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler \
            else self.lr
        return lr * self.lr_mult.get(self._name(index), 1.0)

    def _get_wd(self, index) -> float:
        return self.wd * self.wd_mult.get(self._name(index), 1.0)

    def _preprocess(self, grads):
        """rescale and clip, into new tensors (the gradient buffers stay
        as backward wrote them)."""
        g = torch._foreach_mul(grads, self.rescale_grad)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(g, -self.clip_gradient)
            torch._foreach_clamp_max_(g, self.clip_gradient)
        return g

    def _preprocess_one(self, grad):
        """``_preprocess`` of one gradient."""
        g = grad.mul(self.rescale_grad)
        if self.clip_gradient is not None:
            g.clamp_min_(-self.clip_gradient).clamp_max_(self.clip_gradient)
        return g

    def create_state(self, index, weight: NDArray):
        return self.init_state_arrays([weight._data])[0]

    def init_state_arrays(self, weights):
        """One state a weight (tensors like it, or None)."""
        raise NotImplementedError

    def apply(self, weights, grads, states, lr, wd, t):
        """Update ``weights`` and ``states`` (lists, one entry a
        parameter; gradients in the weights' dtype) in place: ``lr`` a
        float or a 0-dim float64 tensor, ``wd`` a float, ``t`` this
        update's number (an int, or a 0-dim float64 tensor)."""
        raise NotImplementedError

    def _step(self, w, g, state, lr, wd, t):
        """``apply`` on the one weight ``w`` (Python ``lr`` and ``t``),
        op for op."""
        raise NotImplementedError

    def update(self, index, weight: NDArray, grad: NDArray, state):
        """Update ``weight`` in place from ``grad``; returns the state."""
        self._update_count(index)
        with torch.no_grad():
            self._step(weight._data, grad._data.to(weight._data.dtype),
                       state, self._get_lr(index), self._get_wd(index),
                       self._index_update_count[index])
        return state


_HALF = (torch.bfloat16, torch.float16)


def _widen(tensors):
    """float32 copies of the half-precision tensors, the others as
    they are."""
    return [t.float() if t.dtype in _HALF else t for t in tensors]


def _narrow_into(dst, src):
    """Round each of ``_widen``'s copies ``src`` once into its tensor
    of ``dst``."""
    pairs = [(d, s) for d, s in zip(dst, src) if d is not s]
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])


def _scalar_for(x, tensors):
    """``x`` for a foreach op over ``tensors`` (float32 or float64): a
    Python number as it is, a 0-dim tensor cast to the lists' type, which
    keeps the op on its multi-tensor path."""
    if not isinstance(x, torch.Tensor):
        return x
    return x.to(tensors[0].dtype)


@register
class SGD(Optimizer):
    """SGD with momentum: mom = momentum*mom - lr*(g + wd*w); w += mom."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def init_state_arrays(self, weights):
        if self.momentum == 0.0:
            return [None] * len(weights)
        return [torch.zeros_like(w) for w in weights]

    def apply(self, weights, grads, states, lr, wd, t):
        if not weights:
            return
        g = self._preprocess(_widen(grads))
        torch._foreach_add_(g, weights, alpha=wd)
        torch._foreach_mul_(g, _scalar_for(lr, g))
        w = _widen(weights)
        if self.momentum == 0.0:
            torch._foreach_sub_(w, g)
        else:
            mom = _widen(states)
            torch._foreach_mul_(mom, self.momentum)
            torch._foreach_sub_(mom, g)
            torch._foreach_add_(w, mom)
            _narrow_into(states, mom)
        _narrow_into(weights, w)

    def _step(self, w, g, state, lr, wd, t):
        g, w32 = _widen([g, w])
        g = self._preprocess_one(g)
        g.add_(w, alpha=wd).mul_(lr)
        if self.momentum == 0.0:
            w32.sub_(g)
        else:
            mom, = _widen([state])
            w32.add_(mom.mul_(self.momentum).sub_(g))
            _narrow_into([state], [mom])
        _narrow_into([w], [w32])


@register
class Adam(Optimizer):
    """Adam with the reference's bias correction folded into lr."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def init_state_arrays(self, weights):
        return [(torch.zeros_like(w), torch.zeros_like(w)) for w in weights]

    def apply(self, weights, grads, states, lr, wd, t):
        if not weights:
            return
        m = _widen([s[0] for s in states])
        v = _widen([s[1] for s in states])
        g = self._preprocess(_widen(grads))
        torch._foreach_add_(g, weights, alpha=wd)
        torch._foreach_mul_(m, self.beta1)
        torch._foreach_add_(m, g, alpha=1 - self.beta1)
        torch._foreach_mul_(v, self.beta2)
        torch._foreach_add_(v, torch._foreach_mul(g, g),
                            alpha=1 - self.beta2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.epsilon)
        step = torch._foreach_div(m, denom)
        torch._foreach_mul_(step, _scalar_for(self._lr_t(lr, t), step))
        w = _widen(weights)
        torch._foreach_sub_(w, step)
        _narrow_into([s[0] for s in states], m)
        _narrow_into([s[1] for s in states], v)
        _narrow_into(weights, w)

    def _step(self, w, g, state, lr, wd, t):
        m, v, g, w32 = _widen([*state, g, w])
        g = self._preprocess_one(g)
        g.add_(w, alpha=wd)
        m.mul_(self.beta1).add_(g, alpha=1 - self.beta1)
        v.mul_(self.beta2).add_(g * g, alpha=1 - self.beta2)
        step = m / v.sqrt().add_(self.epsilon)
        w32.sub_(step.mul_(self._lr_t(lr, t)))
        _narrow_into([*state, w], [m, v, w32])

    def _lr_t(self, lr, t):
        """The rate with the bias correction of update ``t`` folded in
        (float64: Python's, or the 0-dim tensors')."""
        coef1 = 1.0 - self.beta1 ** t
        coef2 = 1.0 - self.beta2 ** t
        sqrt = torch.sqrt if isinstance(t, torch.Tensor) else math.sqrt
        return lr * sqrt(coef2) / coef1


class Updater:
    """Per-index state, created at an index's first update.
    ``get_states``/``set_states`` carry it as the JAX package's
    ``Updater`` blob (``mxnet_tpu/optimizer.py:469-476``): a pickle of
    {index: None, an array, or a tuple of arrays}, numpy on the host.  A
    state set from a blob moves to its weight's device (and dtype) at
    that index's next update.  bfloat16 states go through
    ``checkpoint.dumps``/``loads``: as ``ml_dtypes`` arrays in the blob,
    with no ``ml_dtypes`` here."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}

    def __call__(self, index, grad: NDArray, weight: NDArray):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        else:
            self.states[index] = place_state(self.states[index],
                                             weight._data.device,
                                             weight._data.dtype)
        self.states[index] = self.optimizer.update(index, weight, grad,
                                                   self.states[index])

    def get_states(self) -> bytes:
        from .checkpoint import dumps

        return dumps(self.states)

    def set_states(self, states_blob: bytes) -> None:
        from .checkpoint import loads

        self.states = dict(loads(states_blob))


def place_state(tree, device, dtype=None):
    """A state tree (None, an array or tensor, a tuple or list of them)
    as tensors on ``device`` (in ``dtype`` when given); tensors already
    there are kept as they are."""
    if tree is None:
        return None
    if isinstance(tree, (tuple, list)):
        return type(tree)(place_state(x, device, dtype) for x in tree)
    t = tree if isinstance(tree, torch.Tensor) else tensor_from_numpy(tree)
    return t.to(device=device, dtype=dtype or t.dtype)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
