"""Custom operator API — write ops in Python, use them in graphs.

Counterpart of ``mxnet_tpu/operator.py`` (the reference's
``python/mxnet/operator.py:396-580``): subclass ``CustomOpProp`` for the
names and shape/type inference, subclass ``CustomOp`` for forward and
backward over NDArrays, register the prop under a name, then build
symbols with ``mt.sym.Custom(..., op_type=name)`` or call
``mt.nd.Custom``.  The user's NDArrays lie on the op's own device
(``ops/custom.py``); the gradient is a ``torch.autograd.Function`` whose
backward calls ``CustomOp.backward``.
"""

from __future__ import annotations

from .base import MXNetError
from .ops import custom as _custom

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered"]


class CustomOp:
    """Base class for operators implemented in Python (reference:
    operator.py:396 CustomOp)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Override: compute ``out_data`` from ``in_data``.

        req entries are 'null'/'write'/'add'; use ``self.assign``."""
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Override: compute ``in_grad`` from ``out_grad``."""
        raise NotImplementedError

    @staticmethod
    def assign(dst, req, src):
        """Assign ``src`` to ``dst`` per the write request."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError(f"invalid req {req!r}")


class CustomOpProp:
    """Base class for custom-op metadata (reference: operator.py:442
    CustomOpProp).

    Parameters
    ----------
    need_top_grad : bool
        Whether backward needs the gradient from above (False for
        loss-style ops that produce their own gradient).
    """

    def __init__(self, need_top_grad=False):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        """Default: all inputs/outputs share the first input's shape."""
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        """Default: everything takes the first input's dtype."""
        return ([in_type[0]] * len(self.list_arguments()),
                [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """Which tensors backward needs (informational here: the port
        always saves inputs and outputs for the backward)."""
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes=None):
        """Override: return the CustomOp instance."""
        raise NotImplementedError


def register(reg_name):
    """Class decorator registering a CustomOpProp subclass under
    ``reg_name`` (reference: operator.py:554 register)."""

    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register() requires a CustomOpProp subclass")
        _custom._PROPS[reg_name] = prop_cls
        # re-registration must not serve stale cached prop instances
        _custom._cached_prop.cache_clear()
        return prop_cls

    return do_register


def get_all_registered():
    return dict(_custom._PROPS)
