"""VGG (BASELINE's scoring row), carried over from
``mxnet_tpu/models/vgg.py`` (reference:
example/image-classification/symbol_vgg.py): the same layers, widths
and node names, so one parameter dict binds to both packages."""

from .. import symbol as sym


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable(name="data")
    # group 1
    conv1_1 = sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=64,
                              name="conv1_1")
    relu1_1 = sym.Activation(conv1_1, act_type="relu", name="relu1_1")
    pool1 = sym.Pooling(relu1_1, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        name="pool1")
    # group 2
    conv2_1 = sym.Convolution(pool1, kernel=(3, 3), pad=(1, 1), num_filter=128,
                              name="conv2_1")
    relu2_1 = sym.Activation(conv2_1, act_type="relu", name="relu2_1")
    pool2 = sym.Pooling(relu2_1, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        name="pool2")
    # group 3
    conv3_1 = sym.Convolution(pool2, kernel=(3, 3), pad=(1, 1), num_filter=256,
                              name="conv3_1")
    relu3_1 = sym.Activation(conv3_1, act_type="relu", name="relu3_1")
    conv3_2 = sym.Convolution(relu3_1, kernel=(3, 3), pad=(1, 1),
                              num_filter=256,
                              name="conv3_2")
    relu3_2 = sym.Activation(conv3_2, act_type="relu", name="relu3_2")
    pool3 = sym.Pooling(relu3_2, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        name="pool3")
    # group 4
    conv4_1 = sym.Convolution(pool3, kernel=(3, 3), pad=(1, 1), num_filter=512,
                              name="conv4_1")
    relu4_1 = sym.Activation(conv4_1, act_type="relu", name="relu4_1")
    conv4_2 = sym.Convolution(relu4_1, kernel=(3, 3), pad=(1, 1),
                              num_filter=512,
                              name="conv4_2")
    relu4_2 = sym.Activation(conv4_2, act_type="relu", name="relu4_2")
    pool4 = sym.Pooling(relu4_2, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        name="pool4")
    # group 5
    conv5_1 = sym.Convolution(pool4, kernel=(3, 3), pad=(1, 1), num_filter=512,
                              name="conv5_1")
    relu5_1 = sym.Activation(conv5_1, act_type="relu", name="relu5_1")
    conv5_2 = sym.Convolution(relu5_1, kernel=(3, 3), pad=(1, 1),
                              num_filter=512,
                              name="conv5_2")
    relu5_2 = sym.Activation(conv5_2, act_type="relu", name="relu5_2")
    pool5 = sym.Pooling(relu5_2, pool_type="max", kernel=(2, 2), stride=(2, 2),
                        name="pool5")
    # group 6
    flatten = sym.Flatten(pool5, name="flatten")
    fc6 = sym.FullyConnected(flatten, num_hidden=4096, name="fc6")
    relu6 = sym.Activation(fc6, act_type="relu", name="relu6")
    drop6 = sym.Dropout(relu6, p=0.5, name="drop6")
    # group 7
    fc7 = sym.FullyConnected(drop6, num_hidden=4096, name="fc7")
    relu7 = sym.Activation(fc7, act_type="relu", name="relu7")
    drop7 = sym.Dropout(relu7, p=0.5, name="drop7")
    # output
    fc8 = sym.FullyConnected(drop7, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(fc8, name="softmax")
