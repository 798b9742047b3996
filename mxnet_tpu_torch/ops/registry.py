"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py:37-180``.  Every operator is
registered here once and is then visible to the symbolic API
(``mxnet_tpu_torch.symbol.<op>``, generated) and the graph executor,
which composes the registered ``compute`` functions into one Python
function over tensors.

``compute(op_ctx, attrs, inputs, aux)`` takes and returns
``torch.Tensor``s.  Gradients come from autograd over the composed
function, not from per-op backward registrations; ops whose gradient
is not the derivative of their output (the loss heads, whose backward
ignores the incoming gradient) and ops backed by a kernel are
``torch.autograd.Function``s inside their compute.

An op whose compute cannot be recorded into a CUDA graph (its body
synchronizes with the host or runs Python over host values per call)
is registered ``capturable=False``; a symbol that holds one runs the
Module's fused step uncaptured (``module/fused_step.py``).  An op whose
compute launches a hand-written kernel of the port on a CUDA tensor is
registered ``kernel=True`` (or a callable of its attributes);
``predictor.export_model`` refuses a graph that holds one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import MXNetError, attrs_to_str

__all__ = ["OpContext", "OpDef", "register", "get_op", "list_ops",
           "invoke", "same_shape_infer", "broadcast_shape_infer"]


@dataclass
class OpContext:
    """Per-invocation context handed to compute functions: ``is_train``
    and, for ops registered with ``needs_rng=True``, an explicit
    ``torch.Generator`` where the JAX package passes a PRNG key.  In a
    graph ``key`` is the node's 63-bit key, which seeded ``rng``; None
    for an eager call.  Under the Module's fused step ``streams`` holds
    the step's persistent generators (``random.Streams``): ``rng`` is
    then the node's own, seeded once, whose state runs on from step to
    step.  An op that draws sub-streams (the fused RNN's per-layer
    dropout) takes them from ``sub_generator``.  ``device`` is where an
    op with no inputs (``_zeros``, ``_arange``, the samplers) makes its
    output: the executor's context, or the eager call's."""

    is_train: bool = False
    rng: Optional[torch.Generator] = None
    key: Optional[int] = None
    streams: Any = None
    device: Any = None

    def sub_generator(self, i: int, device) -> torch.Generator:
        """The generator of sub-stream ``i`` of this node, keyed
        ``random.sub_key(key, i)``: fresh for an executor forward, the
        persistent one under the fused step, and ``rng`` itself for an
        eager call."""
        from .. import random as _random

        if self.key is None:
            return self.rng
        key = _random.sub_key(self.key, i)
        if self.streams is not None:
            return self.streams.generator(key, device)
        return _random.key_generator(key, device)


# infer_shape: (attrs, in_shapes: List[Optional[tuple]])
#   -> (in_shapes, out_shapes, aux_shapes), raising on inconsistency,
#   leaving None where underdetermined.
InferShapeFn = Callable[[Dict[str, str], List[Optional[tuple]]], Tuple]


@dataclass
class OpDef:
    name: str
    compute: Callable[..., Any]
    # formal input names; a callable (attrs) -> list for bias-optional
    # layers
    arg_names: Any = ("data",)
    aux_names: Any = ()
    out_names: Any = ("output",)
    infer_shape: Optional[InferShapeFn] = None
    needs_rng: bool = False
    # False: the compute cannot be recorded into a CUDA graph
    capturable: bool = True
    # True, or a callable (attrs) -> bool: on a CUDA tensor the compute
    # launches a hand-written kernel of the port
    kernel: Any = False
    # loss head: backward ignores the incoming head gradient, so the
    # executor may seed it with ones
    is_loss: Any = False
    aliases: Tuple[str, ...] = ()
    doc: str = ""

    def loss_head(self, attrs) -> bool:
        return bool(self.is_loss(attrs)) if callable(self.is_loss) \
            else bool(self.is_loss)

    def launches_kernel(self, attrs) -> bool:
        return bool(self.kernel(attrs)) if callable(self.kernel) \
            else bool(self.kernel)

    def input_names(self, attrs) -> List[str]:
        a = self.arg_names
        return list(a(attrs)) if callable(a) else list(a)

    def auxiliary_names(self, attrs) -> List[str]:
        a = self.aux_names
        return list(a(attrs)) if callable(a) else list(a)

    def output_names(self, attrs) -> List[str]:
        a = self.out_names
        return list(a(attrs)) if callable(a) else list(a)


_OPS: Dict[str, OpDef] = {}


def register(name: str, **kwargs):
    """Register an operator; used as a decorator on the compute fn."""

    def _do(fn):
        op = OpDef(name=name, compute=fn, **kwargs)
        _OPS[name] = op
        for alias in op.aliases:
            _OPS[alias] = op
        return fn

    return _do


def get_op(name: str) -> OpDef:
    op = _OPS.get(name)
    if op is None:
        raise MXNetError(
            f"operator {name!r} is not registered in mxnet_tpu_torch (not "
            f"ported yet, or unknown; see ROADMAP.md queue A)")
    return op


def list_ops() -> List[str]:
    return sorted(_OPS)


def invoke(op_name: str, inputs: Sequence[torch.Tensor],
           attrs: Optional[Dict[str, Any]] = None, is_train: bool = False,
           rng: Optional[torch.Generator] = None,
           aux: Sequence[torch.Tensor] = (), device=None):
    """Run a registered op eagerly on tensors → (outputs, new_aux).
    ``device`` is the device of an op without inputs (the CPU when not
    given); an op with inputs runs on theirs."""
    op = get_op(op_name)
    attrs = attrs_to_str(attrs or {})
    device = inputs[0].device if inputs else torch.device(device or "cpu")
    if op.needs_rng and rng is None:
        from .. import random as _random

        rng = _random.generator(device)
    op_ctx = OpContext(is_train=bool(is_train), rng=rng, device=device)
    if aux:
        outs, new_aux = op.compute(op_ctx, attrs, list(inputs), list(aux))
    else:
        outs, new_aux = op.compute(op_ctx, attrs, list(inputs), []), []
    if not isinstance(outs, (list, tuple)):
        outs = [outs]
    return list(outs), list(new_aux)


# ---------------------------------------------------------------------------
# shape-inference helpers shared by op families
# ---------------------------------------------------------------------------


def same_shape_infer(n_in: int = 1, n_out: int = 1):
    """All inputs and outputs share one shape (elemwise family)."""

    def infer(attrs, in_shapes):
        known = next((s for s in in_shapes if s is not None), None)
        ins = [known if s is None else s for s in in_shapes]
        if known is not None:
            for s in ins:
                if s != known:
                    raise MXNetError(f"elemwise shape mismatch: {in_shapes}")
        return ins, [known] * n_out, []

    return infer


def broadcast_shape_infer(attrs, in_shapes):
    a, b = in_shapes
    if a is None or b is None:
        return in_shapes, [None], []
    try:
        out = np.broadcast_shapes(tuple(a), tuple(b))
    except ValueError as e:
        raise MXNetError(f"broadcast shape mismatch {a} vs {b}") from e
    return [a, b], [tuple(out)], []
