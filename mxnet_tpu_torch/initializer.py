"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py:35-106``: name dispatch
(``upsampling*`` → bilinear, bias and beta → 0, gamma → 1, weight and
the fused RNN's packed ``parameters`` → the initializer's own rule,
``moving_mean``/``running_mean``/``moving_inv_var``/``moving_avg`` → 0,
``moving_var``/``running_var`` → 1, any other name raises), ``Zero``,
``One``, ``Constant``, ``Uniform``, ``Normal`` and ``Xavier``.  A
variable whose symbol carries an ``init`` attr (``Variable(...,
init=...)``, e.g. ``pos_embed_weight``'s ``["zero", {}]``) is
initialized by that initializer instead (``InitDesc`` carries the
attrs).

Random draws come from ``random.generator(device)``, the explicit
generator that ``random.seed`` reseeds.  They cannot reproduce the JAX
package's threefry draws.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, Registry
from .ndarray import NDArray

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier", "register", "create"]

_REGISTRY = Registry("initializer")


def register(klass):
    _REGISTRY.register(klass.__name__, klass)
    return klass


def create(init) -> "Initializer":
    """An initializer from an instance, a name, or its JSON dump
    ``'["name", {kwargs}]'``."""
    if isinstance(init, Initializer):
        return init
    if isinstance(init, str) and init.lstrip().startswith("["):
        name, kwargs = json.loads(init)
        return _REGISTRY.get(name)(**kwargs)
    return _REGISTRY.get(str(init))()


class InitDesc(str):
    """A parameter name with its symbol attrs (``__init__`` among them)."""

    def __new__(cls, name, attrs=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        return ret


class Initializer:
    """Base: dispatch on the parameter name."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, name, arr: NDArray):
        if not isinstance(name, str):
            raise TypeError("name must be a string")
        if not isinstance(arr, NDArray):
            raise TypeError("arr must be NDArray")
        own = getattr(name, "attrs", {}).get("__init__")
        if own:
            create(own)._init_weight(name, arr)
        elif name.startswith("upsampling"):
            self._init_bilinear(name, arr)
        elif name.endswith("bias") or name.endswith("beta"):
            self._init_zero(name, arr)
        elif name.endswith("gamma"):
            self._init_one(name, arr)
        elif name.endswith("weight") or name.endswith("parameters"):
            # "parameters": the fused RNN's packed vector, weight-like
            self._init_weight(name, arr)
        elif name.endswith(("moving_mean", "running_mean", "moving_inv_var",
                            "moving_avg")):
            self._init_zero(name, arr)
        elif name.endswith(("moving_var", "running_var")):
            self._init_one(name, arr)
        else:
            self._init_default(name, arr)

    def _init_bilinear(self, _, arr):
        shape = arr.shape
        weight = np.zeros(int(np.prod(shape)), dtype="float32")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(int(np.prod(shape))):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        arr[:] = weight.reshape(shape)

    def _init_zero(self, _, arr):
        arr[:] = 0.0

    def _init_one(self, _, arr):
        arr[:] = 1.0

    def _init_default(self, name, _):
        raise MXNetError(
            f"Unknown initialization pattern for {name!r}. Default "
            "initialization is limited to weight/bias/gamma/beta/"
            "parameters/moving_* names")

    def _init_weight(self, name, arr):
        raise NotImplementedError("must override _init_weight")


def _draw_(arr: NDArray, draw):
    """``draw(float32 tensor, generator)`` into ``arr``: values are drawn
    in float32 and cast to the array's dtype, as the JAX package samples
    a float32 array into a bf16 or fp16 parameter (so a half-precision
    network starts from its float32 twin's values, rounded)."""
    t = arr._data
    gen = _random.generator(t.device)
    with torch.no_grad():
        if t.dtype == torch.float32:
            draw(t, gen)
        else:
            t.copy_(draw(torch.empty(t.shape, dtype=torch.float32,
                                     device=t.device), gen))


def _uniform_(arr: NDArray, low: float, high: float):
    _draw_(arr, lambda t, gen: t.uniform_(low, high, generator=gen))


def _normal_(arr: NDArray, sigma: float):
    _draw_(arr, lambda t, gen: t.normal_(0.0, sigma, generator=gen))


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 0.0


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        arr[:] = 1.0


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        arr[:] = self.value


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _uniform_(arr, -self.scale, self.scale)


@register
class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _normal_(arr, self.sigma)


@register
class Xavier(Initializer):
    """Xavier/Glorot: scale sqrt(magnitude / factor) from the fans."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        shape = arr.shape
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("Incorrect factor type")
        scale = float(np.sqrt(self.magnitude / factor))
        if self.rnd_type == "uniform":
            _uniform_(arr, -scale, scale)
        elif self.rnd_type == "gaussian":
            _normal_(arr, scale)
        else:
            raise MXNetError("Unknown random type")
