"""Carry parameters from the JAX package (or any numpy source) into the
port.

A checkpoint of the JAX package is a dict of arrays named by the
training symbol's arguments (``mod.get_params()`` then ``.asnumpy()``).
The port's modules take the same names, so one dict binds to both.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

import numpy as np
import torch

from .context import Context

__all__ = ["params_from_numpy"]


def params_from_numpy(params: Mapping[str, object],
                      device: Union[torch.device, str, Context, None] = None,
                      dtype: torch.dtype = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """``{name: array}`` → ``{name: tensor}`` on ``device`` in ``dtype``.

    Values may be numpy arrays, anything with ``.asnumpy()`` (the JAX
    package's NDArray), or tensors.  ``device`` is a ``torch.device``,
    a device string or a ``Context``; None means the current context
    (``gpu(0)`` unless a ``with cpu():`` scope says otherwise)."""
    if device is None or isinstance(device, Context):
        from .context import current_context
        device = (device or current_context()).torch_device()
    device = torch.device(device)
    out = {}
    for name, v in params.items():
        if isinstance(v, torch.Tensor):
            t = v.detach()
        else:
            arr = v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)
            # a copy: the source may be read-only (a JAX array's view)
            t = torch.from_numpy(np.array(arr, copy=True, order="C"))
        out[name] = t.to(device=device, dtype=dtype).contiguous()
    return out
