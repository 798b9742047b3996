"""Engine control: the host's face of the execution scheduler.

Counterpart of ``mxnet_tpu/engine.py:49-110``.  CUDA's streams are the
engine here: ops queue device work and return, and ``wait_to_read``/
``waitall`` are the blocking points.  What stays on the host is the
reference's control surface: ``set_engine_type`` and
``MXNET_ENGINE_TYPE`` (read once, at import), where ``NaiveEngine`` is
the debugging mode that finishes every executor run and training step
on the card before it returns (``sync_if_naive``), so a fault shows at
the call that caused it; ``push`` of a host closure after its arrays
are ready; ``wait_for_var`` and ``wait_all``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .base import MXNetError, get_env

__all__ = ["set_engine_type", "engine_type", "is_naive", "sync_if_naive",
           "push", "wait_for_var", "wait_all"]

_VALID = ("NaiveEngine", "ThreadedEngine", "ThreadedEnginePerDevice")
DEFAULT_ENGINE_TYPE = "ThreadedEnginePerDevice"

_engine_type = get_env("MXNET_ENGINE_TYPE", DEFAULT_ENGINE_TYPE, str)
if _engine_type not in _VALID:
    raise MXNetError(
        f"MXNET_ENGINE_TYPE={_engine_type!r} is not one of {_VALID}")
_naive = _engine_type == "NaiveEngine"


def engine_type() -> str:
    return _engine_type


def set_engine_type(name: str) -> None:
    """'NaiveEngine': every executor run and training step finishes on
    the device before it returns; the two threaded names: the normal
    asynchronous queueing."""
    global _engine_type, _naive
    if name not in _VALID:
        raise MXNetError(f"unknown engine type {name!r}; one of {_VALID}")
    _engine_type = name
    _naive = name == "NaiveEngine"


def is_naive() -> bool:
    return _naive


def sync_if_naive(arrays) -> None:
    """Under NaiveEngine, wait for the devices of ``arrays`` (NDArrays or
    tensors) to finish their queued work."""
    if not _naive:
        return
    for dev in {(a._data if hasattr(a, "_data") else a).device
                for a in arrays}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def wait_for_var(arr) -> None:
    """Block until ``arr``'s value is final."""
    arr.wait_to_read()


def wait_all() -> None:
    from . import ndarray as nd

    nd.waitall()


def push(fn: Callable[[], None], read_arrays: Sequence = (),
         write_arrays: Sequence = ()) -> None:
    """Run a host closure once the arrays it reads and writes are ready
    (checkpoint writers, logging)."""
    for a in list(read_arrays) + list(write_arrays):
        wait_for_var(a)
    fn()
