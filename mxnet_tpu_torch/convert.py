"""Carry parameters between the JAX package (or any numpy source) and
the port.

A checkpoint of the JAX package is a dict of arrays named by the
training symbol's arguments (``mod.get_params()`` then ``.asnumpy()``).
The port's modules take the same names, so one dict binds to both;
``params_to_numpy`` is the way back, for comparing weights.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

from .context import Context
from .ndarray import NDArray, tensor_from_numpy, tensor_to_host

__all__ = ["params_from_numpy", "params_to_numpy"]


def params_from_numpy(params: Mapping[str, object],
                      device: Union[torch.device, str, Context, None] = None,
                      dtype: Optional[torch.dtype] = torch.float32
                      ) -> Dict[str, torch.Tensor]:
    """``{name: array}`` → ``{name: tensor}`` on ``device`` in ``dtype``;
    ``dtype=None`` keeps each value's own dtype (float64 narrowed to
    float32, as the JAX package holds it).

    Values may be numpy arrays (the JAX package's bfloat16 parameters,
    ``ml_dtypes`` arrays, are read through their bits), anything with
    ``.asnumpy()`` (the JAX package's NDArray), ``HostBF16`` or tensors.
    ``device`` is a ``torch.device``, a device string or a ``Context``;
    None means the current context (``gpu(0)`` unless a ``with cpu():``
    scope says otherwise)."""
    if device is None or isinstance(device, Context):
        from .context import current_context
        device = (device or current_context()).torch_device()
    device = torch.device(device)
    out = {}
    for name, v in params.items():
        if isinstance(v, torch.Tensor):
            t = v.detach()
        else:
            # a copy: the source may be read-only (a JAX array's view)
            t = tensor_from_numpy(v.asnumpy() if hasattr(v, "asnumpy")
                                  else v)
        want = dtype if dtype is not None else (
            torch.float32 if t.dtype == torch.float64 else t.dtype)
        out[name] = t.to(device=device, dtype=want).contiguous()
    return out


def params_to_numpy(params: Mapping[str, object]) -> Dict[str, object]:
    """``{name: tensor or NDArray}`` → ``{name: host array}``: a numpy
    array in the value's dtype, or for bfloat16, which numpy has no type
    for without ``ml_dtypes``, a ``HostBF16`` (the bits; never a widened
    float32 copy): ``.tensor()`` gives it back as a tensor, and
    ``checkpoint.dumps`` pickles it as an ``ml_dtypes`` array."""
    return {name: tensor_to_host(v._data if isinstance(v, NDArray) else v)
            for name, v in params.items()}
