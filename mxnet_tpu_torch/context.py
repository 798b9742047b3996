"""Device context: ``cpu()`` / ``gpu(i)`` over ``torch.device``.

Counterpart of ``mxnet_tpu/context.py``.  The default context is
``gpu(0)``: the port's entry points run on the card unless the caller
asks for the host with ``ctx=cpu()``.  Resolving a ``gpu`` context on a
host without CUDA raises instead of falling back to the CPU.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "current_context"]


class Context:
    """Device context ``(device_type, device_id)``, usable as a ``with``
    scope like the reference's."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {"cpu": 1, "gpu": 2}

    _default = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError(f"unknown device type {device_type!r}; "
                                 f"the port knows cpu and gpu")
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)
        self._old_ctx: Optional[Context] = None

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __str__(self):
        return f"{self.device_type}({self.device_id})"

    __repr__ = __str__

    def __enter__(self):
        self._old_ctx = getattr(Context._default, "ctx", None)
        Context._default.ctx = self
        return self

    def __exit__(self, *args):
        Context._default.ctx = self._old_ctx
        return False

    def torch_device(self) -> torch.device:
        """The ``torch.device`` this context names.  A ``gpu`` context
        on a host without a usable CUDA card raises: nothing of the
        port carries on quietly on the CPU."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                f"{self} asks for an NVIDIA card, but torch finds no CUDA "
                f"device on this host; pass ctx=cpu() to run on the CPU")
        n = torch.cuda.device_count()
        if self.device_id >= n:
            raise MXNetError(f"{self} is out of range: torch finds {n} "
                             f"CUDA device(s)")
        return torch.device("cuda", self.device_id)


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope, else ``gpu(0)``."""
    ctx = getattr(Context._default, "ctx", None)
    return ctx if ctx is not None else gpu(0)
