"""Error type and environment reading for the PyTorch port.

Counterpart of ``mxnet_tpu/base.py``: the same ``MXNetError`` name (the
reference's ``mxnet.base.MXNetError``) and the same ``MXNET_*``
environment convention, kept as an own copy so the port never imports
the JAX package.
"""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["MXNetError", "get_env", "not_ported"]


class MXNetError(RuntimeError):
    """Error raised by the framework (name kept for API parity with the
    reference's ``mxnet.base.MXNetError``)."""


def get_env(name: str, default, dtype: Optional[type] = None):
    """Read an ``MXNET_*`` environment variable; ``default`` when unset."""
    val = os.environ.get(name)
    if val is None:
        return default
    if dtype is None:
        dtype = type(default) if default is not None else str
    if dtype is bool:
        return val not in ("0", "false", "False", "")
    return dtype(val)


def not_ported(feature: str) -> MXNetError:
    """The error a feature of the JAX package that this port does not
    carry yet raises when it is asked for — never silently ignored."""
    return MXNetError(f"{feature} is not ported yet to mxnet_tpu_torch "
                      f"(see ROADMAP.md queue A)")
