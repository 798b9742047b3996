"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py``: ``EvalMetric``,
``CompositeEvalMetric`` (``:78``), ``Accuracy`` (``:142``),
``TopKAccuracy`` (``:205``), ``F1`` (``:232``), ``Perplexity``
(``:262``), ``MAE``, ``MSE``, ``RMSE`` (``:363-405``), ``CrossEntropy``
(``:408``), ``Loss`` (``:426``), ``Torch`` and ``Caffe`` (``:438-446``),
``CustomMetric`` (``:449``), ``np`` (``:477``) and ``create`` of a
name, an instance, a callable or a list (``:494``).  ``Accuracy``,
``Perplexity``, ``TopKAccuracy`` (2-D predictions) and ``MAE``/``MSE``/
``RMSE`` score NDArray predictions where they lie and read one sum
back in ``get``, so ``update`` waits for nothing; the other metrics,
and the cases those leave to the host, sum ``asnumpy()`` of each
batch's outputs, the reference's numpy path.
"""

from __future__ import annotations

import numpy
import torch

from .base import Registry
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy", "Loss",
           "Torch", "Caffe", "CustomMetric", "np", "create"]

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


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get`` gives their names and
    values as two lists."""

    def __init__(self, metrics=None, **kwargs):
        super().__init__("composite", **kwargs)
        self.metrics = [create(m) if isinstance(m, str) else m
                        for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric) if isinstance(metric, str)
                            else metric)

    def get_metric(self, index):
        if not 0 <= index < len(self.metrics):
            raise ValueError(f"Metric index {index} is out of range 0 to "
                             f"{len(self.metrics)}")
        return self.metrics[index]

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", ()):
            metric.reset()

    def get(self):
        names, results = [], []
        for metric in self.metrics:
            name, value = metric.get()
            names.append(name)
            results.append(value)
        return (names, results)


class _DeviceSum(EvalMetric):
    """A metric that adds each batch's value to a float64 scalar where
    the predictions lie, and its count on the host; ``get`` reads the
    sum back once."""

    def __init__(self, name):
        super().__init__(name)
        self._dev = None

    def reset(self):
        super().reset()
        self._dev = None

    def _dev_add(self, value, num):
        value = value.to(torch.float64)
        self._dev = (value, num) if self._dev is None \
            else (self._dev[0] + value, self._dev[1] + num)

    def get(self):
        if self._dev is not None:
            total, num = self._dev
            self.sum_metric += float(total)
            self.num_inst += num
            self._dev = None
        return super().get()


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


class TopKAccuracy(_DeviceSum):
    """Whether the label is among the ``top_k`` largest predictions.
    (N, C) NDArray predictions are counted where they lie (``topk``; the
    reference's ``argsort`` may order tied scores otherwise); other
    inputs take the reference's numpy path."""

    def __init__(self, top_k=1, **kwargs):
        super().__init__("top_k_accuracy")
        self.top_k = top_k
        if self.top_k <= 1:
            raise ValueError("Please use Accuracy if top_k is no more "
                             "than 1")
        self.name += f"_{self.top_k}"

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred_label in zip(labels, preds):
            if isinstance(pred_label, NDArray) and pred_label.ndim == 2 \
                    and tuple(numpy.shape(label)) == pred_label.shape[:1]:
                p = pred_label._data.float()
                lab = (label._data if isinstance(label, NDArray)
                       else torch.as_tensor(numpy.asarray(label)))
                lab = lab.to(p.device, non_blocking=True).to(torch.int32)
                k = min(p.shape[1], self.top_k)
                idx = torch.topk(p, k, dim=1).indices.to(torch.int32)
                self._dev_add((idx == lab[:, None]).sum(), p.shape[0])
                continue
            pred_label = numpy.argsort(_as_np(pred_label).astype("float32"),
                                       axis=-1)
            label = _as_np(label).astype("int32")
            check_label_shapes(label, pred_label)
            num_samples = pred_label.shape[0]
            if pred_label.ndim == 1:
                self.sum_metric += int((pred_label.flat == label.flat).sum())
            elif pred_label.ndim == 2:
                num_classes = pred_label.shape[1]
                for j in range(min(num_classes, self.top_k)):
                    self.sum_metric += int(
                        (pred_label[:, num_classes - 1 - j].flat
                         == label.flat).sum())
            self.num_inst += num_samples


class F1(EvalMetric):
    """Binary F1 of the argmax of (N, 2) predictions, one value a
    batch."""

    def __init__(self):
        super().__init__("f1")

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _as_np(pred)
            label = _as_np(label).astype("int32")
            pred_label = numpy.argmax(pred, axis=1)
            check_label_shapes(label, pred)
            if len(numpy.unique(label)) > 2:
                raise ValueError("F1 currently only supports binary "
                                 "classification.")
            tp = float(((pred_label == 1) & (label == 1)).sum())
            fp = float(((pred_label == 1) & (label == 0)).sum())
            fn = float(((pred_label == 0) & (label == 1)).sum())
            precision = tp / (tp + fp) if tp + fp > 0 else 0.0
            recall = tp / (tp + fn) if tp + fn > 0 else 0.0
            f1 = 2 * precision * recall / (precision + recall) \
                if precision + recall > 0 else 0.0
            self.sum_metric += f1
            self.num_inst += 1


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


class _Regression(_DeviceSum):
    """One value a batch from the batch's error: a 1-D label is taken as
    a column (N, 1), broadcast against the prediction.  NDArray
    predictions are scored where they lie, numpy ones on the host."""

    def _reduce(self, err, xp):
        raise NotImplementedError

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            if isinstance(pred, NDArray):
                p = pred._data
                lab = (label._data if isinstance(label, NDArray)
                       else torch.as_tensor(numpy.asarray(label)))
                lab = lab.to(p.device, non_blocking=True)
                if lab.ndim == 1:
                    lab = lab.reshape(lab.shape[0], 1)
                self._dev_add(self._reduce(lab - p, torch), 1)
                continue
            label = _as_np(label)
            pred = _as_np(pred)
            if len(label.shape) == 1:
                label = label.reshape(label.shape[0], 1)
            self.sum_metric += self._reduce(label - pred, numpy)
            self.num_inst += 1


class MAE(_Regression):
    """Mean absolute error."""

    def __init__(self):
        super().__init__("mae")

    def _reduce(self, err, xp):
        return xp.abs(err).mean()


class MSE(_Regression):
    """Mean squared error."""

    def __init__(self):
        super().__init__("mse")

    def _reduce(self, err, xp):
        return (err ** 2.0).mean()


class RMSE(_Regression):
    """Root of the mean squared error, a batch."""

    def __init__(self):
        super().__init__("rmse")

    def _reduce(self, err, xp):
        return xp.sqrt((err ** 2.0).mean())


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


class Torch(Loss):
    """The loss output's mean, under the name ``torch``."""

    def __init__(self, name="torch"):
        super().__init__()
        self.name = name


class Caffe(Torch):
    """The loss output's mean, under the name ``caffe``."""

    def __init__(self):
        super().__init__(name="caffe")


class CustomMetric(EvalMetric):
    """A metric from ``feval(label, pred)`` over numpy arrays, returning
    a value or a (sum, count) pair."""

    def __init__(self, feval, name=None, allow_extra_outputs=False):
        if name is None:
            name = feval.__name__
            if name.find("<") != -1:
                name = f"custom({name})"
        super().__init__(name)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for pred, label in zip(preds, labels):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A ``CustomMetric`` over a numpy function, named after it."""

    def feval(label, pred):
        return numpy_feval(label, pred)

    feval.__name__ = numpy_feval.__name__
    return CustomMetric(feval, name, allow_extra_outputs)


for _cls in (Accuracy, TopKAccuracy, F1, Perplexity, MAE, MSE, RMSE,
             CrossEntropy, Loss, Torch, Caffe):
    _REGISTRY.register(_cls.__name__, _cls)
_REGISTRY.register("acc", Accuracy)
_REGISTRY.register("ce", CrossEntropy)


def create(metric, **kwargs) -> EvalMetric:
    """A metric from a callable (a ``CustomMetric``), an instance, a list
    (a ``CompositeEvalMetric`` of each) or a registered name."""
    if callable(metric):
        return CustomMetric(metric)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, **kwargs))
        return composite
    return _REGISTRY.get(str(metric))(**kwargs)
