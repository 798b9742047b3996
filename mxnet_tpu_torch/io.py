"""Data iterators.

Counterpart of ``mxnet_tpu/io.py:59-310``: ``DataDesc``, ``DataBatch``,
``DataIter``, ``NDArrayIter`` (shuffle, ``last_batch_handle`` pad /
discard / roll_over) and ``ResizeIter``.  Batches are host (CPU)
NDArrays; the module that consumes them stages each one onto its own
device, into the arrays it bound.  ``state_dict``/``set_state`` give a
checkpoint the position of ``NDArrayIter`` (its cursor and shuffle
order) and ``ResizeIter`` in the JAX iterators' form
(``mxnet_tpu/io.py:120-140, 236-260, 312-320``); other iterators raise.
A source keeps its dtype in ``provide_data``/``provide_label``, so that
``Module.bind`` types the network in it: a bfloat16 source (an NDArray,
a tensor or an ``ml_dtypes`` array) is held as a CPU tensor and
described as ``"bfloat16"``.
"""

from __future__ import annotations

from collections import namedtuple

import numpy as np
import torch

from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array, dtype_name, tensor_from_numpy

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter",
           "ResizeIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Name and shape of an input, with its dtype and layout."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret


class DataBatch:
    """One batch: data and label lists, pad and index."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base iterator."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self) -> bool:
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError

    def state_dict(self):
        """The iterator's position for a checkpoint (builtins and
        numpy); iterators that cannot give one raise."""
        raise MXNetError(f"{type(self).__name__} does not support "
                         "checkpointing (state_dict)")

    def set_state(self, state, rewind=False):
        """Restore a ``state_dict``: the next batch is the one the
        snapshotted iterator would have given next (with ``rewind``, the
        first of its epoch)."""
        raise MXNetError(f"{type(self).__name__} does not support "
                         "checkpointing (set_state)")


def _init_data(data, allow_empty, default_name):
    """Normalize input data to a sorted list of (name, numpy array)."""
    if data is None:
        if not allow_empty:
            raise ValueError("data is required")
        data = []
    if isinstance(data, (np.ndarray, NDArray, torch.Tensor)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("data is required")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return sorted((k, _host_source(v)) for k, v in data.items())


def _host_source(v):
    """A source on the host: a numpy array, or a CPU bfloat16 tensor for
    a bfloat16 source (an NDArray, a tensor or an ``ml_dtypes`` array),
    which numpy cannot hold without ``ml_dtypes``."""
    if isinstance(v, NDArray):
        v = v._data
    if isinstance(v, torch.Tensor):  # a copy, as asnumpy gives
        t = v.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    v = np.asarray(v)
    return tensor_from_numpy(v) if v.dtype.name == "bfloat16" else v


def _desc(name, shape, dtype):
    """A DataDesc with a tensor source's dtype by name ("bfloat16")."""
    if isinstance(dtype, torch.dtype):
        dtype = dtype_name(dtype)
    return DataDesc(name, shape, dtype)


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays in batches along axis 0."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.num_data = self.data[0][1].shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size")
        # a permutation view: rows stay in place, batches index through it
        self._order = np.arange(self.num_data)
        if shuffle:
            np.random.shuffle(self._order)
        if last_batch_handle == "discard":
            self.num_data -= self.num_data % batch_size
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [_desc(k, (self.batch_size,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [_desc(k, (self.batch_size,) + tuple(v.shape[1:]), v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" \
                and self.cursor > self.num_data:
            self.cursor = -self.batch_size \
                + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        end = self.cursor + self.batch_size
        if end <= self.num_data:
            sel = self._order[self.cursor:end]
        else:  # padded last batch wraps around
            sel = np.concatenate([self._order[self.cursor:self.num_data],
                                  self._order[:end - self.num_data]])
        return [array(x[1][torch.from_numpy(sel)]
                      if isinstance(x[1], torch.Tensor) else x[1][sel],
                      ctx=cpu()) for x in data_source]

    def state_dict(self):
        return {"kind": "NDArrayIter", "cursor": int(self.cursor),
                "order": self._order.copy(), "num_data": int(self.num_data),
                "batch_size": int(self.batch_size)}

    def set_state(self, state, rewind=False):
        if state.get("kind") != "NDArrayIter":
            raise MXNetError(f"NDArrayIter.set_state: snapshot is for "
                             f"{state.get('kind')!r}")
        if int(state["num_data"]) != self.num_data or \
                int(state["batch_size"]) != self.batch_size:
            raise MXNetError(
                "NDArrayIter.set_state: snapshot shape mismatch "
                f"(saved num_data={state['num_data']}/batch_size="
                f"{state['batch_size']}, this iterator has "
                f"{self.num_data}/{self.batch_size})")
        order = np.asarray(state["order"])
        if order.shape != self._order.shape:
            raise MXNetError("NDArrayIter.set_state: corrupt shuffle order")
        self._order = order.copy()
        self.cursor = -self.batch_size if rewind else int(state["cursor"])

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" \
                and self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class ResizeIter(DataIter):
    """``size`` batches an epoch from ``data_iter``, which is reset and
    read again whenever it runs out (``mxnet_tpu/io.py:270``).  With
    ``reset_internal`` every ``reset`` also resets ``data_iter``;
    without it, the next epoch goes on where this one stopped."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad

    def state_dict(self):
        return {"kind": "ResizeIter", "cur": int(self.cur),
                "inner": self.data_iter.state_dict()}

    def set_state(self, state, rewind=False):
        if state.get("kind") != "ResizeIter":
            raise MXNetError("ResizeIter.set_state: wrong snapshot kind")
        self.data_iter.set_state(state["inner"], rewind=rewind)
        self.cur = 0 if rewind else int(state["cur"])
