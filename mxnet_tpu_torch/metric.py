"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric``, ``Accuracy``
(``:142``), ``Perplexity`` (``:262``), ``CrossEntropy`` (``:408``),
``Loss`` (``:426``) and ``create``.  ``Accuracy`` and ``Perplexity``
score NDArray predictions where they lie and read one sum back in
``get``; the other metrics, and the cases those two leave to the host,
sum ``asnumpy()`` of each batch's outputs, the reference's numpy path.
"""

from __future__ import annotations

import numpy
import torch

from .base import Registry, not_ported
from .ndarray import NDArray

__all__ = ["EvalMetric", "Accuracy", "Perplexity", "CrossEntropy", "Loss",
           "create"]

_REGISTRY = Registry("metric")


def check_label_shapes(labels, preds, shape=0):
    if shape == 0:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise ValueError(f"Shape of labels {label_shape} does not match "
                         f"shape of predictions {pred_shape}")


def _as_np(x):
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


class EvalMetric:
    """Base metric accumulating (sum_metric, num_inst)."""

    def __init__(self, name, num=None):
        self.name = name
        self.num = num
        self.reset()

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        if self.num is None:
            self.num_inst = 0
            self.sum_metric = 0.0
        else:
            self.num_inst = [0] * self.num
            self.sum_metric = [0.0] * self.num

    def get(self):
        if self.num is None:
            if self.num_inst == 0:
                return (self.name, float("nan"))
            return (self.name, self.sum_metric / self.num_inst)
        names = [f"{self.name}_{i}" for i in range(self.num)]
        values = [s / n if n != 0 else float("nan")
                  for s, n in zip(self.sum_metric, self.num_inst)]
        return (names, values)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


class Accuracy(EvalMetric):
    """Classification accuracy; predictions with a trailing class axis
    are reduced by argmax (the first maximum, as ``jnp.argmax``).

    A pair of NDArrays whose shapes are equal, or differ by the
    prediction's trailing class axis, is counted where the prediction
    lies (``mxnet_tpu/metric.py:122-192``): the count adds to a device
    scalar, the prediction never crosses to the host, and ``get`` reads
    the sum back once.  A label on another device (the port's iterators
    give host batches, where the JAX package's lie on the default
    device) moves to the prediction's first, as ``Perplexity``'s does.
    Anything else takes the reference's numpy path."""

    def __init__(self):
        super().__init__("accuracy")
        self._dev = None  # (correct, count) summed where preds lie

    def reset(self):
        super().reset()
        self._dev = None

    def get(self):
        if self._dev is not None:
            correct, num = self._dev
            self.sum_metric += int(correct)
            self.num_inst += num
            self._dev = None
        return super().get()

    def _device_update(self, label, pred):
        p = pred._data
        if p.shape != label._data.shape:
            p = torch.argmax(p, dim=-1)
        lab = label._data.to(p.device, non_blocking=True)
        correct = (p.to(torch.int32).reshape(-1)
                   == lab.to(torch.int32).reshape(-1)).sum()
        num = lab.numel()
        self._dev = (correct, num) if self._dev is None \
            else (self._dev[0] + correct, self._dev[1] + num)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            if isinstance(label, NDArray) and isinstance(pred_label, NDArray):
                ps, ls = pred_label.shape, label.shape
                if ps == ls or (len(ps) == len(ls) + 1 and ps[:-1] == ls):
                    self._device_update(label, pred_label)
                    continue
            pred_label = _as_np(pred_label)
            label = _as_np(label)
            if pred_label.ndim > label.ndim or (
                    pred_label.ndim == label.ndim
                    and pred_label.shape != label.shape):
                pred_label = numpy.argmax(pred_label, axis=-1)
            pred_label = pred_label.astype("int32").reshape(-1)
            label = label.astype("int32").reshape(-1)
            check_label_shapes(label, pred_label, shape=1)
            self.sum_metric += int((pred_label == label).sum())
            self.num_inst += len(pred_label)


class Perplexity(EvalMetric):
    """exp of the mean negative log-probability of the labels, over
    softmax outputs; ``ignore_label`` rows are left out.

    One (labels, preds) pair with preds an NDArray is scored where preds
    lie, the label moved there (``mxnet_tpu/metric.py:290-343``): the
    softmax output never crosses to the host, and the weighted sums are
    read back once, by ``get``."""

    def __init__(self, ignore_label=None, axis=-1):
        super().__init__("Perplexity")
        self.ignore_label = ignore_label
        self.axis = axis
        self._dev = None  # (perplexity * count, count) summed where preds lie

    def reset(self):
        super().reset()
        self._dev = None

    def get(self):
        if self._dev is not None:
            ppl, num = self._dev
            self.sum_metric += float(ppl)
            self.num_inst += int(num)
            self._dev = None
        return super().get()

    def _device_update(self, label, pred):
        p = pred._data
        p = torch.movedim(p, self.axis, -1).reshape(-1, p.shape[self.axis])
        lab = label._data if isinstance(label, NDArray) \
            else torch.as_tensor(numpy.asarray(label))
        lab = lab.to(p.device).reshape(-1).long()
        # the JAX gather's indexing: a label in [-C, 0) wraps, then any
        # label clamps into [0, C); ignored rows are masked after it
        C = p.shape[1]
        idx = torch.where(lab < 0, lab + C, lab).clamp(0, C - 1)
        probs = p.gather(1, idx[:, None])[:, 0].float()
        num = torch.tensor(lab.shape[0], device=p.device)
        if self.ignore_label is not None:
            ignore = lab == int(self.ignore_label)
            probs = torch.where(ignore, 1.0, probs)
            num = num - ignore.sum()
        loss = -torch.log(torch.clamp(probs, min=1e-10)).sum()
        # an all-ignored batch adds nothing, as the host path's "if num"
        ppl = torch.where(num > 0, torch.exp(loss / num.clamp(min=1)) * num,
                          0.0)
        self._dev = (ppl, num) if self._dev is None \
            else (self._dev[0] + ppl, self._dev[1] + num)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        if len(preds) == 1 and isinstance(preds[0], NDArray) \
                and preds[0].ndim >= 2 \
                and preds[0].size // preds[0].shape[self.axis] \
                == int(numpy.prod(numpy.shape(labels[0]))):
            self._device_update(labels[0], preds[0])
            return
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _as_np(label).reshape(-1).astype("int32")
            pred = numpy.moveaxis(_as_np(pred), self.axis, -1)
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[numpy.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = label == self.ignore_label
                probs = numpy.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= float(numpy.sum(numpy.log(numpy.maximum(1e-10,
                                                            probs))))
            num += label.shape[0]
        if num:
            self.sum_metric += numpy.exp(loss / num) * num
            self.num_inst += num


class CrossEntropy(EvalMetric):
    """Cross entropy of (N, C) softmax outputs against int labels."""

    def __init__(self, eps=1e-8):
        super().__init__("cross-entropy")
        self.eps = eps

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _as_np(label).ravel()
            pred = _as_np(pred)
            if label.shape[0] != pred.shape[0]:
                raise ValueError(f"CrossEntropy: {label.shape[0]} labels "
                                 f"for {pred.shape[0]} predictions")
            prob = pred[numpy.arange(label.shape[0]), numpy.int64(label)]
            self.sum_metric += float((-numpy.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


class Loss(EvalMetric):
    """Mean of the output itself (for loss heads such as SoftmaxCELoss)."""

    def __init__(self):
        super().__init__("loss")

    def update(self, _, preds):
        for pred in preds:
            p = _as_np(pred)
            self.sum_metric += float(p.sum())
            self.num_inst += p.size


for _cls in (Accuracy, Perplexity, CrossEntropy, Loss):
    _REGISTRY.register(_cls.__name__, _cls)
_REGISTRY.register("acc", Accuracy)
_REGISTRY.register("ce", CrossEntropy)


def create(metric, **kwargs) -> EvalMetric:
    """A metric from an instance or a registered name."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        raise not_ported("composite metrics")
    return _REGISTRY.get(str(metric))(**kwargs)
