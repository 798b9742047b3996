"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py:35-106``: name dispatch
(``upsampling*`` → bilinear, bias and beta → 0, gamma → 1, weight and
the fused RNN's packed ``parameters`` → the initializer's own rule,
``moving_mean``/``running_mean``/``moving_inv_var``/``moving_avg`` → 0,
``moving_var``/``running_var`` → 1, any other name raises), ``Zero``,
``One``, ``Constant``, ``Uniform``, ``Normal``, ``Orthogonal``
(``:137``), ``Xavier``, ``MSRAPrelu`` (``:252``), and the two
dispatchers that are not ``Initializer``s, ``Load`` (``:109``: a saved
dict, else a default) and ``Mixed`` (``:198``: the first matching
pattern's initializer).  A
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
import re

import numpy as np
import torch

from . import random as _random
from .base import MXNetError, Registry
from .ndarray import NDArray

__all__ = ["Initializer", "InitDesc", "Zero", "One", "Constant", "Uniform",
           "Normal", "Orthogonal", "Xavier", "MSRAPrelu", "Load", "Mixed",
           "register", "create"]

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


class Load:
    """Parameters from a saved dict (an ``nd.save`` file's name, or a
    name → array dict; ``arg:``/``aux:`` prefixes dropped), the others
    from ``default_init``."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load as nd_load

            param = nd_load(param)
        self.param = {name.replace("arg:", "").replace("aux:", ""): arr
                      for name, arr in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if name in self.param:
            if tuple(self.param[name].shape) != tuple(arr.shape):
                raise MXNetError(f"Parameter {name} shape mismatch: "
                                 f"{self.param[name].shape} vs {arr.shape}")
            arr[:] = self.param[name]
        elif self.default_init is None:
            raise MXNetError(f"Cannot init parameter {name} — not in loaded "
                             "file and no default_init given")
        else:
            self.default_init(name, arr)


class Mixed:
    """The initializer of the first of ``patterns`` (regular expressions,
    matched at the name's start) that matches a name."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must have same "
                             "length")
        self.map = list(zip([re.compile(p) for p in patterns], initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError(f"Parameter {name} did not match any pattern")


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
class Orthogonal(Initializer):
    """``scale`` times an orthonormal (nout, prod(rest)) matrix: the U or
    V of the SVD of a float64 uniform(-1, 1) or normal(0, 1) draw,
    whichever has the draw's shape."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        shape = arr.shape
        nout, nin = shape[0], int(np.prod(shape[1:]))
        dev = arr._data.device
        gen = _random.generator(dev)
        tmp = torch.empty((nout, nin), dtype=torch.float64, device=dev)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=gen)
        else:
            tmp.normal_(0.0, 1.0, generator=gen)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        res = u if u.shape == tmp.shape else v
        with torch.no_grad():
            arr._data.copy_((self.scale * res).reshape(shape))


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


@register
class MSRAPrelu(Xavier):
    """He initialization for PReLU nets: Xavier's gaussian with magnitude
    2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}
