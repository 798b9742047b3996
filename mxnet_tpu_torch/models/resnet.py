"""ResNet (BASELINE config 2), carried over from
``mxnet_tpu/models/resnet.py`` (reference:
example/image-classification/symbol_resnet.py): 18/34/50/101/152/200/269
layers at ImageNet shapes, the cifar family (20, 32, 44, 56, 110, ...,
164+ bottleneck) at height <= 32.

``stem="conv7"`` is the reference's stem; ``"s2d"`` (``_s2d_stem``) is
the JAX package's 7x7 stem re-expressed as a 4x4 convolution over a 2x2
space-to-depth input (``mxnet_tpu/models/resnet.py:59-96``), an exact
reparametrization (``conv7_to_s2d_weight``).  It applies at ImageNet
shapes only; the cifar stem is a 3x3 convolution either way.
"""

import numpy as np

from .. import symbol as sym

__all__ = ["get_symbol", "resnet", "residual_unit", "conv7_to_s2d_weight"]


def residual_unit(data, num_filter, stride, dim_match, name, bottle_neck=True,
                  bn_mom=0.9, workspace=256):
    """reference: symbol_resnet.py residual_unit (pre-activation)."""
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=int(num_filter * 0.25),
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=int(num_filter * 0.25),
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                            name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv3")
        if dim_match:
            shortcut = data
        else:
            shortcut = sym.Convolution(act1, num_filter=num_filter,
                                       kernel=(1, 1), stride=stride,
                                       no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + "_conv2")
    if dim_match:
        shortcut = data
    else:
        shortcut = sym.Convolution(act1, num_filter=num_filter, kernel=(1, 1),
                                   stride=stride, no_bias=True,
                                   name=name + "_sc")
    return conv2 + shortcut


def _s2d_stem(data, num_filter):
    """conv0 as a 4x4/stride-1 convolution over the 2x2 space-to-depth
    of the image padded by 3 (224 -> 230 -> 115 blocks): every 7x7/
    stride-2 window lands on 4x4 whole blocks, so no further padding."""
    body = sym.space_to_depth(data, block_size=2, pad=(3, 3),
                              channel_order="group_major", name="s2d")
    return sym.Convolution(body, num_filter=num_filter, kernel=(4, 4),
                           stride=(1, 1), pad=(0, 0), no_bias=True,
                           name="conv0")


def conv7_to_s2d_weight(w7):
    """A (O, C, 7, 7) conv0 weight in the (O, 4C, 4, 4) layout of the
    s2d stem, so both stems compute the same function."""
    w7 = np.asarray(w7)
    o, c = w7.shape[:2]
    w4 = np.zeros((o, 4 * c, 4, 4), dtype=w7.dtype)
    ch = np.arange(c) * 4
    for ky in range(7):
        for kx in range(7):
            w4[:, ch + 2 * (ky % 2) + (kx % 2), ky // 2, kx // 2] = \
                w7[:, :, ky, kx]
    return w4


def resnet(units, num_stages, filter_list, num_classes, image_shape,
           bottle_neck=True, bn_mom=0.9, workspace=256, stem="conv7"):
    """reference: symbol_resnet.py resnet; ``stem`` "conv7" or "s2d"."""
    if stem not in ("conv7", "s2d"):
        raise ValueError(f"unknown stem {stem!r} (conv7 or s2d)")
    num_unit = len(units)
    if num_unit != num_stages:
        raise ValueError(f"{num_unit} unit counts for {num_stages} stages")
    data = sym.Variable(name="data")
    data = sym.BatchNorm(data, fix_gamma=True, eps=2e-5, momentum=bn_mom,
                         name="bn_data")
    (nchannel, height, width) = image_shape
    if height <= 32:  # cifar
        body = sym.Convolution(data, num_filter=filter_list[0], kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True,
                               name="conv0")
    else:  # imagenet
        if stem == "s2d":
            body = _s2d_stem(data, filter_list[0])
        else:
            body = sym.Convolution(data, num_filter=filter_list[0],
                                   kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                                   no_bias=True, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                             name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")

    for i in range(num_stages):
        body = residual_unit(body, filter_list[i + 1],
                             (1 if i == 0 else 2, 1 if i == 0 else 2),
                             False, name=f"stage{i + 1}_unit1",
                             bottle_neck=bottle_neck, bn_mom=bn_mom,
                             workspace=workspace)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name=f"stage{i + 1}_unit{j + 2}",
                                 bottle_neck=bottle_neck, bn_mom=bn_mom,
                                 workspace=workspace)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(pool1)
    fc1 = sym.FullyConnected(flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


def get_symbol(num_classes=1000, num_layers=50, image_shape=(3, 224, 224),
               conv_workspace=256, stem="conv7", **kwargs):
    """reference: symbol_resnet.py get_symbol; ``num_layers`` in {18,
    34, 50, 101, 152, 200, 269} at ImageNet shapes, 6n + 2 (9n + 2 from
    164, bottleneck) at height <= 32."""
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    (nchannel, height, width) = image_shape
    if height <= 32:  # cifar-style
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError(f"no experiments done on num_layers {num_layers}")
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        units_map = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3], 200: [3, 24, 36, 3],
            269: [3, 30, 48, 8],
        }
        if num_layers not in units_map:
            raise ValueError(f"no experiments done on num_layers {num_layers}")
        units = units_map[num_layers]

    return resnet(units=units, num_stages=num_stages, filter_list=filter_list,
                  num_classes=num_classes, image_shape=image_shape,
                  bottle_neck=bottle_neck, workspace=conv_workspace, stem=stem)
