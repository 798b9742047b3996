"""Elementwise ops: the unary table, ``BlockGrad``, ``Cast``, ``clip``,
the same-shape binary table, the broadcasting table, the scalar table
(attr ``scalar``: what ``Symbol`` arithmetic with a number builds),
``add_n`` and ``_grad_add``.

Counterpart of ``mxnet_tpu/ops/elemwise.py:32-282``, with its own copy
of the tables' names and aliases.  The JAX behaviours kept:

- ``gamma`` is ``exp(gammaln(x))``, so its sign at negative
  non-integers is lost, as in the JAX op;
- ``round``/``rint`` round half to even; ``%`` is floor modulo (the
  result takes the divisor's sign);
- comparisons and logical ops give 0/1 in the (left) input's dtype;
- ``abs``'s gradient at 0 is 1, as ``jnp.abs``'s;
- ``maximum``/``minimum`` and ``clip`` split the gradient evenly
  between tied operands (``torch.maximum``'s rule is ``jnp.maximum``'s;
  ``clip`` is ``minimum(maximum(x, a_min), a_max)`` as ``jnp.clip``,
  not ``torch.clamp``, which passes it whole at the bounds);
- a Python scalar takes the tensor's dtype when that is a float (bf16
  stays bf16) and makes an integer tensor float32, as JAX's weakly
  typed scalars do;
- a division by (or of) a number is a true division on every device
  (``_scalar_tensor_op``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import attr_float, attr_int
from ..ndarray import torch_dtype
from .registry import broadcast_shape_infer, register, same_shape_infer

__all__ = []


def _cbrt(x):
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def _abs(x):
    """|x| with ``jnp.abs``'s gradient at 0 (1, where ``torch.abs``'s is
    0); the + 0 turns -0.0 into 0.0."""
    return torch.where(x < 0, -x, x) + 0


_UNARY = {
    "_copy": lambda x: x.clone(),
    "negative": torch.neg,
    "abs": _abs,
    "sign": torch.sign,
    "round": torch.round,
    "rint": torch.round,
    "ceil": torch.ceil,
    "floor": torch.floor,
    "fix": torch.trunc,
    "trunc": torch.trunc,
    "square": torch.square,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp,
    "log": torch.log,
    "log10": torch.log10,
    "log2": torch.log2,
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "tanh": torch.tanh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "softsign": F.softsign,
    "erf": torch.erf,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

_UNARY_ALIASES = {"_copy": ("identity",), "negative": ("_np_negative",)}


def _make_unary(name, fn):
    def compute(op_ctx, attrs, inputs, aux):
        return [fn(inputs[0])]

    register(name, arg_names=("data",), infer_shape=same_shape_infer(1, 1),
             aliases=_UNARY_ALIASES.get(name, ()),
             doc=f"Elementwise {name}")(compute)


for _n, _f in _UNARY.items():
    _make_unary(_n, _f)


@register("BlockGrad", arg_names=("data",), infer_shape=same_shape_infer(1, 1),
          aliases=("stop_gradient",), doc="Identity with no gradient")
def _block_grad(op_ctx, attrs, inputs, aux):
    return [inputs[0].detach()]


@register("Cast", arg_names=("data",), infer_shape=same_shape_infer(1, 1),
          aliases=("cast",), doc="Cast to attrs['dtype']")
def _cast(op_ctx, attrs, inputs, aux):
    return [inputs[0].to(torch_dtype(attrs["dtype"]))]


def _with_scalar(x, s):
    """``x`` and a 0-dim tensor of ``s`` on its device in their common
    dtype under JAX's weak typing (``torch.result_type``'s rule: a float
    tensor keeps its dtype, an integer one meets a float scalar as
    float32).  The scalar is a fill, not a copy from the host, so a CUDA
    graph can hold it."""
    dt = torch.result_type(x, s)
    return x.to(dt), x.new_full((), s, dtype=dt)


@register("clip", arg_names=("data",), infer_shape=same_shape_infer(1, 1),
          doc="Clip to [a_min, a_max]; at a bound the gradient is halved, "
              "as jnp.clip's")
def _clip(op_ctx, attrs, inputs, aux):
    x, lo = _with_scalar(inputs[0], attr_float(attrs.get("a_min")))
    hi = x.new_full((), attr_float(attrs.get("a_max")))
    return [torch.minimum(torch.maximum(x, lo), hi)]


def _cmp(fn):
    return lambda a, b: fn(a, b).to(a.dtype)


def _logical(fn):
    return lambda a, b: fn(a != 0, b != 0).to(a.dtype)


_BINARY = {
    "elemwise_add": torch.add,
    "elemwise_sub": torch.sub,
    "elemwise_mul": torch.mul,
    "elemwise_div": torch.div,
    "_power": torch.pow,
    "_maximum": torch.maximum,
    "_minimum": torch.minimum,
    "_hypot": torch.hypot,
    "_equal": _cmp(torch.eq),
    "_not_equal": _cmp(torch.ne),
    "_greater": _cmp(torch.gt),
    "_greater_equal": _cmp(torch.ge),
    "_lesser": _cmp(torch.lt),
    "_lesser_equal": _cmp(torch.le),
}

_BINARY_ALIASES = {
    "elemwise_add": ("_plus", "_add"),
    "elemwise_sub": ("_minus", "_sub"),
    "elemwise_mul": ("_mul",),
    "elemwise_div": ("_div",),
    "_power": ("pow",),
}


def _make_binary(name, fn, infer, aliases):
    def compute(op_ctx, attrs, inputs, aux):
        return [fn(inputs[0], inputs[1])]

    register(name, arg_names=("lhs", "rhs"), infer_shape=infer,
             aliases=aliases, doc=f"Elementwise {name} of two inputs")(compute)


for _n, _f in _BINARY.items():
    _make_binary(_n, _f, same_shape_infer(2, 1), _BINARY_ALIASES.get(_n, ()))


_BROADCAST = {
    "broadcast_add": torch.add,
    "broadcast_sub": torch.sub,
    "broadcast_mul": torch.mul,
    "broadcast_div": torch.div,
    "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow,
    "broadcast_maximum": torch.maximum,
    "broadcast_minimum": torch.minimum,
    "broadcast_hypot": torch.hypot,
    "broadcast_equal": _cmp(torch.eq),
    "broadcast_not_equal": _cmp(torch.ne),
    "broadcast_greater": _cmp(torch.gt),
    "broadcast_greater_equal": _cmp(torch.ge),
    "broadcast_lesser": _cmp(torch.lt),
    "broadcast_lesser_equal": _cmp(torch.le),
    "broadcast_logical_and": _logical(torch.logical_and),
    "broadcast_logical_or": _logical(torch.logical_or),
    "broadcast_logical_xor": _logical(torch.logical_xor),
}

_BROADCAST_ALIASES = {
    "broadcast_add": ("broadcast_plus",),
    "broadcast_sub": ("broadcast_minus",),
}

for _n, _f in _BROADCAST.items():
    _make_binary(_n, _f, broadcast_shape_infer,
                 _BROADCAST_ALIASES.get(_n, ()))


def _scalar_cmp(fn):
    return lambda x, s: fn(x, s).to(x.dtype)


def _scalar_tensor_op(fn):
    """``fn(x, s)`` over ``x`` and the scalar as a 0-dim tensor: for the
    torch ops that take no Python number in that place, for
    ``maximum``/``minimum``, whose gradient is split at ties, and for
    division, which on a CUDA tensor by a Python number multiplies by the
    reciprocal (and ``s / x`` is ``reciprocal(x) * s``), where ``jnp``
    divides."""
    return lambda x, s: fn(*_with_scalar(x, s))


_SCALAR = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": _scalar_tensor_op(torch.div),
    "_rdiv_scalar": _scalar_tensor_op(lambda x, s: torch.div(s, x)),
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": _scalar_tensor_op(lambda x, s: torch.remainder(s, x)),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    "_maximum_scalar": _scalar_tensor_op(torch.maximum),
    "_minimum_scalar": _scalar_tensor_op(torch.minimum),
    "_hypot_scalar": _scalar_tensor_op(torch.hypot),
    "_equal_scalar": _scalar_cmp(torch.eq),
    "_not_equal_scalar": _scalar_cmp(torch.ne),
    "_greater_scalar": _scalar_cmp(torch.gt),
    "_greater_equal_scalar": _scalar_cmp(torch.ge),
    "_lesser_scalar": _scalar_cmp(torch.lt),
    "_lesser_equal_scalar": _scalar_cmp(torch.le),
}


def _make_scalar(name, fn):
    def compute(op_ctx, attrs, inputs, aux):
        return [fn(inputs[0], attr_float(attrs.get("scalar", 0.0)))]

    register(name, arg_names=("data",), infer_shape=same_shape_infer(1, 1),
             doc=f"{name} of the input and attrs['scalar']")(compute)


for _n, _f in _SCALAR.items():
    _make_scalar(_n, _f)


def _sum_args(attrs):
    return [f"arg{i}" for i in range(attr_int(attrs.get("num_args", 1)))]


@register("add_n", arg_names=_sum_args, aliases=("ElementWiseSum", "_sum"),
          infer_shape=lambda attrs, s: same_shape_infer(len(s), 1)(attrs, s),
          doc="Sum of the num_args inputs, left to right")
def _add_n(op_ctx, attrs, inputs, aux):
    out = inputs[0]
    for x in inputs[1:]:
        out = out + x
    return [out]


@register("_grad_add", arg_names=("lhs", "rhs"),
          infer_shape=same_shape_infer(2, 1),
          doc="Sum of two same-shape inputs (gradient accumulation)")
def _grad_add(op_ctx, attrs, inputs, aux):
    return [inputs[0] + inputs[1]]
