"""The port's SSD workflow (``examples/ssd.py``, BASELINE config 4)
against the JAX package: the symbol of ``models/ssd.py`` against the
example's, one forward and backward of the training symbol from the
same parameters and batch, detection through ``set_params`` into a
second module, and a few training steps on the CPU that lower the loss.
SSD300 (``ssd300_symbol``) is built with both packages' ``sym``: the
same arguments and shapes at the published widths, and one forward and
backward at a sixteenth of the widths (300x300, batch 2) from the same
parameters.

Inputs come from ``synthetic_shapes`` with a numpy seed; parameters are
drawn with numpy at Xavier's scale and handed to both packages
(threefry draws cannot be reproduced).
No multi-step parity: hard-negative mining ranks anchors by probability,
which amplifies ulps into other targets after a few steps.

Tolerances (fp32): ``cls_target`` exact; outputs rtol=atol=1e-5;
gradients rtol 1e-4, atol 1e-5 (three convolutions' sums in another
order, then summed over 192 anchors); detection classes exact (the
test asserts that no pair of rows lies within 1e-4 of the NMS
threshold), the other columns rtol=atol=1e-5.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models.ssd import synthetic_boxes, ssd300_symbol
from mxnet_tpu_torch.ops import cuda_kernels as ck


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny shapes gain nothing from intra-op threads; one thread keeps
    these tests from crowding the timing-sensitive ones that share the
    host.  The worker's setting is restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
B = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def example():
    """``examples/ssd.py`` as a module.  Its ``common.util`` bootstrap
    needs ``examples/`` on the path and puts the repo root there; the
    path and ``sys.modules`` are restored after loading it."""
    path, modules = list(sys.path), set(sys.modules)
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        spec = importlib.util.spec_from_file_location(
            "ssd_example", os.path.join(REPO, "examples", "ssd.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        for name in set(sys.modules) - modules:
            if name == "common" or name.startswith("common."):
                del sys.modules[name]
    return mod


def test_ssd_symbol_and_data_match_the_example(example):
    jtrain, jdet = example.ssd_symbol()
    ttrain, tdet = mt.models.ssd.ssd_symbol()
    shapes = {"data": (B, 3, 32, 32), "label": (B, 2, 5)}
    for j, t in ((jtrain, ttrain), (jdet, tdet)):
        assert t.list_arguments() == j.list_arguments()
        assert t.list_outputs() == j.list_outputs()
        assert t.infer_shape(**shapes) == tuple(
            [list(x) for x in j.infer_shape(**shapes)])
    for a, b in zip(mt.models.ssd.synthetic_shapes(16, seed=3),
                    example.synthetic_shapes(16, seed=3)):
        np.testing.assert_array_equal(a, b)


def xavier_params(sym, shapes, seed):
    """Every parameter of ``sym``: weights uniform at Xavier's scale
    (magnitude 3, fans averaged), biases zero, drawn with numpy."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in zip(sym.list_arguments(),
                           sym.infer_shape(**shapes)[0]):
        if name in shapes:
            continue
        if name.endswith("bias"):
            out[name] = np.zeros(shape, np.float32)
            continue
        hw = float(np.prod(shape[2:]))
        scale = np.sqrt(3.0 / ((shape[0] + shape[1]) * hw / 2.0))
        out[name] = rng.uniform(-scale, scale, shape).astype(np.float32)
    return out


def _internal(sym, name):
    return sym.get_internals()[name]


def _tarray(x):
    return mt.nd.array(x, ctx=mt.cpu())


# (symbol library, its CPU context, an NDArray from numpy on it)
SIDES = ((mx, mx.cpu(), mx.nd.array), (mt, mt.cpu(), _tarray))


def test_ssd_step_and_detection_match_jax(example):
    jtrain, jdet = example.ssd_symbol()
    ttrain, tdet = mt.models.ssd.ssd_symbol()
    X, Y = mt.models.ssd.synthetic_shapes(B, seed=1)
    shapes = {"data": X.shape, "label": Y.shape}
    host = xavier_params(ttrain, shapes, seed=0)

    # one forward and backward of the training group
    jex = jtrain.simple_bind(mx.cpu(), **shapes)
    tex = ttrain.simple_bind(mt.cpu(), **shapes)
    for ex in (jex, tex):
        for k, v in host.items():
            ex.arg_dict[k][:] = v
    jex.forward(is_train=True, data=mx.nd.array(X), label=mx.nd.array(Y))
    jex.backward()
    tex.forward(is_train=True, data=X, label=Y)
    tex.backward()
    for j, t in zip(jex.outputs, tex.outputs):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **FWD)
    for k in host:
        g = tex.grad_dict[k].asnumpy()
        assert np.abs(g).max() > 0, k
        np.testing.assert_allclose(g, jex.grad_dict[k].asnumpy(),
                                   err_msg=k, **GRAD)

    # the same targets: the MultiBoxTarget output of both graphs
    targets = []
    for sym, (_, ctx, arr) in zip((jtrain, ttrain), SIDES):
        ex = _internal(sym, "tgt_cls_target").simple_bind(
            ctx, grad_req="null", **shapes)
        for k, v in host.items():
            if k in ex.arg_dict:
                ex.arg_dict[k][:] = v
        ex.forward(data=arr(X), label=arr(Y))
        targets.append(ex.outputs[0].asnumpy())
    np.testing.assert_array_equal(targets[1], targets[0])
    assert (targets[0] > 0).any() and (targets[0] == 0).any() \
        and (targets[0] == -1).any()

    # detection through set_params into a second module
    rows = []
    for sym, (lib, ctx, arr) in zip((jdet, tdet), SIDES):
        dmod = lib.mod.Module(sym, label_names=("label",), context=ctx)
        dmod.bind(data_shapes=[("data", X.shape)],
                  label_shapes=[("label", Y.shape)], for_training=False)
        dmod.set_params({k: arr(v) for k, v in host.items()}, {})
        dmod.forward(lib.io.DataBatch([arr(X)], [arr(Y)]), is_train=False)
        rows.append(dmod.get_outputs()[0].asnumpy())
    jrows, trows = rows
    assert trows.shape == (B, 192, 6)
    assert _no_pair_near_threshold(tdet, host, X, Y)
    np.testing.assert_array_equal(trows[:, :, 0], jrows[:, :, 0])
    np.testing.assert_allclose(trows[:, :, 1:], jrows[:, :, 1:], **FWD)


def _no_pair_near_threshold(det_sym, host, X, Y, thr=0.5, margin=1e-4):
    """No two rows of one class that are live before NMS (score at or
    above the 0.4 threshold; the port's rows, within 1e-5 of JAX's) have
    an IoU within ``margin`` of ``thr``: both packages then decide every
    pair alike."""
    cls_prob, loc_preds, anchors = det_sym.get_children()
    raw = mt.sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                   nms_threshold="0", threshold="0.4")
    ex = raw.simple_bind(mt.cpu(), grad_req="null", data=X.shape,
                         label=Y.shape)
    for k, v in host.items():
        ex.arg_dict[k][:] = v
    ex.forward(data=X, label=Y)
    before = ex.outputs[0].asnumpy().astype(np.float64)
    for r in before:
        live = r[r[:, 0] >= 0]
        l, t, rr, b = (live[:, k] for k in range(2, 6))
        w = np.clip(np.minimum(rr[:, None], rr) - np.maximum(l[:, None], l),
                    0, None)
        h = np.clip(np.minimum(b[:, None], b) - np.maximum(t[:, None], t),
                    0, None)
        inter = w * h
        area = (rr - l) * (b - t)
        union = area[:, None] + area - inter
        iou = np.where(union > 0, inter / np.maximum(union, 1e-12), 0)
        pair = np.triu(np.ones_like(iou, bool), 1) \
            & (live[:, None, 0] == live[None, :, 0])
        if np.any(np.abs(iou[pair] - thr) < margin):
            return False
    return True


SSD300_SHAPES = {"data": (32, 3, 300, 300), "label": (32, 3, 5)}


@pytest.mark.parametrize("filters_div", [1, 16])
def test_ssd300_symbol_matches_between_packages(filters_div):
    jtrain, jdet = ssd300_symbol(filters_div=filters_div, symbol_api=mx.sym)
    ttrain, tdet = ssd300_symbol(filters_div=filters_div)
    for j, t in ((jtrain, ttrain), (jdet, tdet)):
        assert t.list_arguments() == j.list_arguments()
        assert t.list_outputs() == j.list_outputs()
        assert t.infer_shape(**SSD300_SHAPES) == tuple(
            [list(x) for x in j.infer_shape(**SSD300_SHAPES)])
    args, outs, _ = ttrain.infer_shape(**SSD300_SHAPES)
    assert outs == [(32, 21, 8732), (32, 8732 * 4), (32, 8732)]
    assert tdet.infer_shape(**SSD300_SHAPES)[1] == [(32, 8732, 6)]
    if filters_div == 1:  # SSD300 over VGG16-reduced: 26.3M parameters
        assert sum(int(np.prod(s)) for n, s in zip(
            ttrain.list_arguments(), args)
            if n not in SSD300_SHAPES) == 26_285_486


def test_ssd300_step_matches_jax():
    """One forward and backward of SSD300's training group at a
    sixteenth of the widths: every output and ``cls_target`` (exact),
    every gradient; ``Module.init_params`` gives the L2 scale its own
    ``Constant(20)``."""
    jtrain, _ = ssd300_symbol(filters_div=16, symbol_api=mx.sym)
    ttrain, _ = ssd300_symbol(filters_div=16)
    X, Y = synthetic_boxes(2, seed=1)
    shapes = {"data": X.shape, "label": Y.shape}
    host = xavier_params(ttrain, shapes, seed=0)
    host["relu4_3_scale"][:] = 20.0
    jex = jtrain.simple_bind(mx.cpu(), **shapes)
    tex = ttrain.simple_bind(mt.cpu(), **shapes)
    for ex in (jex, tex):
        for k, v in host.items():
            ex.arg_dict[k][:] = v
    jex.forward(is_train=True, data=mx.nd.array(X), label=mx.nd.array(Y))
    jex.backward()
    tex.forward(is_train=True, data=X, label=Y)
    tex.backward()
    for j, t in zip(jex.outputs, tex.outputs):
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), **FWD)
    cls_target = tex.outputs[2].asnumpy()
    np.testing.assert_array_equal(cls_target, jex.outputs[2].asnumpy())
    assert (cls_target > 0).any() and (cls_target == 0).any()
    for k in host:
        np.testing.assert_allclose(tex.grad_dict[k].asnumpy(),
                                   jex.grad_dict[k].asnumpy(), err_msg=k,
                                   **GRAD)
    assert np.abs(tex.grad_dict["relu4_3_scale"].asnumpy()).max() > 0

    mod = mt.mod.Module(ttrain, label_names=("label",), context=mt.cpu())
    mod.bind(data_shapes=[("data", X.shape)],
             label_shapes=[("label", Y.shape)])
    mod.init_params(mt.initializer.Xavier())
    np.testing.assert_array_equal(
        mod.get_params()[0]["relu4_3_scale"].asnumpy(),
        np.full((1, 32, 1, 1), 20.0, np.float32))


def test_ssd_trains_on_the_cpu_and_detects_through_set_params():
    """A few Adam steps at the example's settings lower the masked class
    cross-entropy (read from cls_prob and the MultiBoxTarget output of a
    module sharing the parameters) and the localization loss; then the
    detection module, filled by ``set_params(*mod.get_params())``, runs
    NMS once a forward through the wrapper (on the CPU: the plain
    version, no kernel launch)."""
    train_sym, det_sym = mt.models.ssd.ssd_symbol()
    X, Y = mt.models.ssd.synthetic_shapes(32, seed=2)
    np.random.seed(0)
    it = mt.io.NDArrayIter(X, Y, batch_size=8, shuffle=True,
                           label_name="label", last_batch_handle="discard")
    mt.random.seed(0)
    mod = mt.mod.Module(train_sym, label_names=("label",), context=mt.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 0.005})
    tgt = mt.mod.Module(_internal(train_sym, "tgt_cls_target"),
                        label_names=("label",), context=mt.cpu())
    tgt.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False, shared_module=mod)
    ce, loc = [], []
    for _ in range(4):
        it.reset()
        ce_e, loc_e = [], []
        for batch in it:
            mod.forward(batch, is_train=True)
            mod.backward()
            tgt.forward(batch, is_train=False)  # before the update
            mod.update()
            prob, loc_loss = (o.asnumpy() for o in mod.get_outputs())
            t = tgt.get_outputs()[0].asnumpy()
            keep = t >= 0
            p = np.take_along_axis(prob, np.maximum(t, 0).astype(int)[:, None],
                                   1)[:, 0]
            ce_e.append(-np.log(p[keep]).mean())
            loc_e.append(loc_loss.sum(1).mean())
        ce.append(np.mean(ce_e))
        loc.append(np.mean(loc_e))
    assert np.all(np.isfinite(ce)) and np.all(np.isfinite(loc))
    assert ce[-1] < ce[0] and loc[-1] < loc[0], (ce, loc)

    det = mt.mod.Module(det_sym, label_names=("label",), context=mt.cpu())
    det.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
             for_training=False)
    det.set_params(*mod.get_params())
    it.reset()
    ck.reset_launch_counts()
    det.forward(next(it), is_train=False)
    rows = det.get_outputs()[0].asnumpy()
    assert rows.shape == (8, 192, 6) and np.isfinite(rows).all()
    assert ck.LAUNCHES["nms"] == 0
    s = rows[:, :, 1]
    for r in s:
        v = r[r >= 0]
        assert np.all(v[:-1] >= v[1:])  # sorted by score
