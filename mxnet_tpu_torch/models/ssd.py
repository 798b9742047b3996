"""SSD detectors (BASELINE config 4): the toy of ``examples/ssd.py``
and SSD300 over VGG16-reduced at its published widths.

``ssd_symbol`` and ``synthetic_shapes`` are carried over line for line
from ``examples/ssd.py:25-78``, with the port's ``sym``: two 3x3
convolutions of 16 and 32 filters, each followed by relu and a 2x2 max
pool, one detection head on the 8x8 map of a 3x32x32 image with 3
anchors a pixel (A = 192), ``MultiBoxTarget`` with 3:1 hard-negative
mining, a multi-output softmax over 3 classes (background + 2) and a
smooth-L1 localization loss; ``MultiBoxDetection`` decodes and
suppresses at inference.

``ssd300_symbol`` is upstream MXNet's ``example/ssd`` SSD300 (Liu et
al., ECCV 2016) as its ``symbol/vgg16_reduced.py``,
``symbol/symbol_factory.py`` (``vgg16_reduced``, data shape 300),
``symbol/common.py`` and ``symbol/symbol_builder.py`` build it:
VGG16 with a 3x3 stride-1 ``pool5`` and ``fc6``/``fc7`` as a dilated
3x3 and a 1x1 convolution, four extra stages, an L2-normalized and
scaled ``relu4_3``, and heads on the 38, 19, 10, 5, 3 and 1 maps of a
300x300 image: A = 8732 anchors, 21 classes (PASCAL VOC's 20 +
background).  Two settings of the upstream symbol that the repo's
``MultiBoxPrior`` and ``MultiBoxDetection`` do not take are left out:
the prior ``steps`` (the anchor centres fall at (i + 0.5) / map size
instead of multiples of 8, 16, 32, 64, 100 and 300 pixels) and
``nms_topk=400`` (NMS runs over every row).  The training group leaves
out upstream's ``det_out`` output (a detection in every training
forward) and keeps ``cls_label``, the class target.
"""

import numpy as np

from .. import initializer
from .. import symbol as sym

__all__ = ["NUM_CLASSES", "ssd_symbol", "synthetic_shapes",
           "SSD300_CLASSES", "ssd300_symbol", "synthetic_boxes"]

NUM_CLASSES = 3  # background + 2 object classes in cls space


def ssd_symbol(num_classes=NUM_CLASSES, apx=3):
    """(train_sym, det_sym): the training group [cls_prob, loc_loss] and
    the detection symbol over the same parameters."""
    data = sym.Variable("data")
    label = sym.Variable("label")
    body = data
    for i, nf in enumerate((16, 32)):
        body = sym.Convolution(body, num_filter=nf, kernel=(3, 3),
                               pad=(1, 1), name=f"conv{i}")
        body = sym.Activation(body, act_type="relu")
        body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                           pool_type="max")
    # one detection head on the 8x8 map
    anchors = sym.MultiBoxPrior(body, sizes="(0.3, 0.6)", ratios="(1, 2)",
                                name="anchors")
    loc = sym.Convolution(body, num_filter=apx * 4, kernel=(3, 3),
                          pad=(1, 1), name="loc_head")
    loc_preds = sym.Flatten(sym.transpose(loc, axes=(0, 2, 3, 1)))
    cls = sym.Convolution(body, num_filter=apx * num_classes,
                          kernel=(3, 3), pad=(1, 1), name="cls_head")
    cls = sym.Reshape(sym.transpose(cls, axes=(0, 2, 3, 1)),
                      shape=(0, -1, num_classes))
    cls_preds = sym.transpose(cls, axes=(0, 2, 1))  # (B, C, A)

    tgt = sym.MultiBoxTarget(anchors, label, cls_preds,
                             overlap_threshold="0.5",
                             negative_mining_ratio="3", name="tgt")
    loc_target, loc_mask, cls_target = tgt[0], tgt[1], tgt[2]
    cls_prob = sym.SoftmaxOutput(cls_preds, cls_target, multi_output=True,
                                 use_ignore=True, ignore_label=-1,
                                 name="cls_prob")
    loc_loss = sym.MakeLoss(
        sym.smooth_l1(loc_mask * (loc_preds - loc_target), scalar="1.0"),
        grad_scale=1.0, name="loc_loss")
    train_sym = sym.Group([cls_prob, loc_loss])

    det_sym = sym.MultiBoxDetection(cls_prob, loc_preds, anchors,
                                    nms_threshold="0.5", threshold="0.4",
                                    name="det")
    return train_sym, det_sym


def synthetic_shapes(num, size=32, seed=0):
    """Squares on noise: class 0 = dim square, class 1 = bright square."""
    rng = np.random.RandomState(seed)
    X = rng.rand(num, 3, size, size).astype(np.float32) * 0.2
    Y = np.full((num, 2, 5), -1.0, np.float32)
    for i in range(num):
        cls = rng.randint(0, 2)
        w = rng.randint(size // 3, size // 2)
        x0 = rng.randint(0, size - w)
        y0 = rng.randint(0, size - w)
        X[i, :, y0:y0 + w, x0:x0 + w] = 0.5 if cls == 0 else 1.0
        Y[i, 0] = [cls, x0 / size, y0 / size, (x0 + w) / size,
                   (y0 + w) / size]
    return X, Y


SSD300_CLASSES = 20  # PASCAL VOC; background is class 0 in cls space
SSD300_SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                (.71, .79), (.88, .961))
SSD300_RATIOS = ((1, 2, .5),) + ((1, 2, .5, 3, 1. / 3),) * 3 \
    + ((1, 2, .5),) * 2


def _floats(xs):
    return "(" + ", ".join(repr(float(x)) for x in xs) + ")"


def _conv_relu(S, x, conv, relu, nf, kernel=(3, 3), pad=(1, 1),
               stride=(1, 1), dilate=(1, 1)):
    x = S.Convolution(x, kernel=kernel, pad=pad, stride=stride,
                      dilate=dilate, num_filter=nf, name=conv)
    return S.Activation(x, act_type="relu", name=relu)


def ssd300_symbol(num_classes=SSD300_CLASSES, nms_threshold=0.45,
                  filters_div=1, symbol_api=None):
    """(train_sym, det_sym) of SSD300: the training group [cls_prob,
    loc_loss, cls_label] and the detection symbol over the same
    parameters.  ``filters_div`` divides every filter count (1: the
    published widths); ``symbol_api`` is the symbol package to build with
    (the port's ``sym`` by default)."""
    S = sym if symbol_api is None else symbol_api

    def nf(n):
        return n // filters_div

    data = S.Variable("data")
    label = S.Variable("label")
    # VGG16-reduced
    x = data
    for g, (n, width) in enumerate(((2, 64), (2, 128), (3, 256), (3, 512),
                                     (3, 512)), 1):
        for i in range(1, n + 1):
            x = _conv_relu(S, x, f"conv{g}_{i}", f"relu{g}_{i}", nf(width))
        if g == 4:
            relu4_3 = x
        if g < 5:  # pool3 ceils: 75 -> 38
            x = S.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2),
                          pooling_convention="full" if g == 3 else "valid",
                          name=f"pool{g}")
    x = S.Pooling(x, pool_type="max", kernel=(3, 3), stride=(1, 1),
                  pad=(1, 1), name="pool5")
    x = _conv_relu(S, x, "fc6", "relu6", nf(1024), pad=(6, 6), dilate=(6, 6))
    x = _conv_relu(S, x, "fc7", "relu7", nf(1024), kernel=(1, 1),
                   pad=(0, 0))
    layers = [("relu4_3", relu4_3), ("relu7", x)]
    # the extra stages: 19 -> 10 -> 5 -> 3 -> 1
    for k, (width, stride, pad) in enumerate(
            ((512, 2, 1), (256, 2, 1), (256, 1, 0), (256, 1, 0)), 2):
        name = f"multi_feat_{k}_conv"
        x = _conv_relu(S, x, f"{name}_1x1_conv", f"{name}_1x1_relu",
                       max(nf(128), nf(width) // 2), kernel=(1, 1),
                       pad=(0, 0))
        x = _conv_relu(S, x, f"{name}_3x3_conv", f"{name}_3x3_relu",
                       nf(width), pad=(pad, pad), stride=(stride, stride))
        layers.append((f"{name}_3x3_relu", x))

    # the multibox heads
    classes = num_classes + 1
    locs, clss, anchors = [], [], []
    for (name, x), sizes, ratios in zip(layers, SSD300_SIZES, SSD300_RATIOS):
        if name == "relu4_3":  # L2 normalization, a learned scale from 20
            x = S.L2Normalization(x, mode="channel", name=f"{name}_norm")
            scale = S.Variable(f"{name}_scale", shape=(1, nf(512), 1, 1),
                               init=initializer.Constant(20).dumps(),
                               wd_mult=0.1)
            x = S.broadcast_mul(scale, x)
        apx = len(sizes) + len(ratios) - 1
        loc = S.Convolution(x, kernel=(3, 3), pad=(1, 1), num_filter=apx * 4,
                            name=f"{name}_loc_pred_conv")
        locs.append(S.Flatten(S.transpose(loc, axes=(0, 2, 3, 1))))
        cls = S.Convolution(x, kernel=(3, 3), pad=(1, 1),
                            num_filter=apx * classes,
                            name=f"{name}_cls_pred_conv")
        clss.append(S.Flatten(S.transpose(cls, axes=(0, 2, 3, 1))))
        anchors.append(S.Flatten(S.MultiBoxPrior(
            x, sizes=_floats(sizes), ratios=_floats(ratios), clip=False,
            name=f"{name}_anchors")))
    n = len(layers)
    loc_preds = S.Concat(*locs, num_args=n, dim=1, name="multibox_loc_pred")
    cls_preds = S.Reshape(S.Concat(*clss, num_args=n, dim=1),
                          shape=(0, -1, classes))
    cls_preds = S.transpose(cls_preds, axes=(0, 2, 1),
                            name="multibox_cls_pred")  # (B, C, A)
    anchor_boxes = S.Reshape(S.Concat(*anchors, num_args=n, dim=1),
                             shape=(0, -1, 4), name="multibox_anchors")

    variances = "(0.1, 0.1, 0.2, 0.2)"
    tgt = S.MultiBoxTarget(anchor_boxes, label, cls_preds,
                           overlap_threshold="0.5", ignore_label="-1",
                           negative_mining_ratio="3",
                           negative_mining_thresh="0.5", variances=variances,
                           name="multibox_target")
    loc_target, loc_mask, cls_target = tgt[0], tgt[1], tgt[2]
    cls_prob = S.SoftmaxOutput(cls_preds, cls_target, ignore_label=-1,
                               use_ignore=True, grad_scale=1.0,
                               multi_output=True, normalization="valid",
                               name="cls_prob")
    loc_loss = S.MakeLoss(
        S.smooth_l1(loc_mask * (loc_preds - loc_target), scalar="1.0",
                    name="loc_loss_"),
        grad_scale=1.0, normalization="valid", name="loc_loss")
    cls_label = S.MakeLoss(cls_target, grad_scale=0, name="cls_label")
    train_sym = S.Group([cls_prob, loc_loss, cls_label])

    det_sym = S.MultiBoxDetection(cls_prob, loc_preds, anchor_boxes,
                                  nms_threshold=str(nms_threshold),
                                  force_suppress=False, variances=variances,
                                  name="detection")
    return train_sym, det_sym


def synthetic_boxes(num, size=300, num_classes=SSD300_CLASSES,
                    max_objects=3, seed=0):
    """Rectangles on noise: 1 to ``max_objects`` boxes an image, 10-50%
    of the side, each filled with its class's colour (a fixed palette);
    labels (num, max_objects, 5) rows [cls, l, t, r, b] in [0, 1], -1
    rows after the last box."""
    rng = np.random.RandomState(seed)
    palette = np.random.RandomState(1).rand(num_classes, 3).astype(
        np.float32) * 0.7 + 0.3
    X = rng.rand(num, 3, size, size).astype(np.float32) * 0.2
    Y = np.full((num, max_objects, 5), -1.0, np.float32)
    for i in range(num):
        for k in range(rng.randint(1, max_objects + 1)):
            cls = rng.randint(0, num_classes)
            w, h = rng.randint(size // 10, size // 2, size=2)
            x0 = rng.randint(0, size - w)
            y0 = rng.randint(0, size - h)
            X[i, :, y0:y0 + h, x0:x0 + w] = palette[cls][:, None, None]
            Y[i, k] = [cls, x0 / size, y0 / size, (x0 + w) / size,
                       (y0 + h) / size]
    return X, Y
