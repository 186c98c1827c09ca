"""SE-ResNeXt (counterpart of ``paddle_tpu/models/se_resnext.py``, built call
for call): ResNeXt bottlenecks with cardinality-32 grouped convolutions and
Squeeze-and-Excitation channel gates (``fluid_benchmark.py``'s
``se_resnext``).  A grouped convolution is one ``conv2d(groups=...)`` call
into cuDNN; the SE gate is two small fcs, the second through ``sigmoid``.
"""

from __future__ import annotations

from .. import fluid


def conv_bn_layer(input, num_filters, filter_size, stride=1, groups=1,
                  act=None):
    conv = fluid.layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=(filter_size - 1) // 2, groups=groups,
        act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act)


def squeeze_excitation(input, num_channels, reduction_ratio=16):
    pool = fluid.layers.pool2d(input=input, pool_type="avg",
                               global_pooling=True)
    squeeze = fluid.layers.fc(input=pool,
                              size=num_channels // reduction_ratio,
                              act="relu")
    excitation = fluid.layers.fc(input=squeeze, size=num_channels,
                                 act="sigmoid")
    scale = fluid.layers.reshape(excitation, shape=[-1, num_channels, 1, 1])
    return fluid.layers.elementwise_mul(x=input, y=scale, axis=0)


def _shortcut(input, ch_out, stride):
    ch_in = input.shape[1]
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride)
    return input


def bottleneck_block(input, num_filters, stride, cardinality=32,
                     reduction_ratio=16):
    conv0 = conv_bn_layer(input, num_filters, 1, act="relu")
    conv1 = conv_bn_layer(conv0, num_filters, 3, stride=stride,
                          groups=cardinality, act="relu")
    conv2 = conv_bn_layer(conv1, num_filters * 2, 1)
    scale = squeeze_excitation(conv2, num_filters * 2, reduction_ratio)
    short = _shortcut(input, num_filters * 2, stride)
    return fluid.layers.elementwise_add(x=short, y=scale, act="relu")


_DEPTH_CFG = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}


def se_resnext_imagenet(input, class_dim=1000, depth=50):
    depth_cfg = _DEPTH_CFG[depth]
    num_filters = [128, 256, 512, 1024]
    conv = conv_bn_layer(input, 64, 7, stride=2, act="relu")
    conv = fluid.layers.pool2d(input=conv, pool_size=3, pool_stride=2,
                               pool_padding=1, pool_type="max")
    for block, n_blocks in enumerate(depth_cfg):
        for i in range(n_blocks):
            conv = bottleneck_block(
                conv, num_filters[block], stride=2 if i == 0 and block != 0
                else 1)
    pool = fluid.layers.pool2d(input=conv, pool_type="avg",
                               global_pooling=True)
    drop = fluid.layers.dropout(x=pool, dropout_prob=0.2)
    return fluid.layers.fc(input=drop, size=class_dim, act="softmax")


def build(class_dim=1000, depth=50, image_shape=(3, 224, 224), lr=None):
    """Returns (img, label, prediction, loss, acc); with ``lr``,
    Momentum(lr, 0.9) minimizes the loss."""
    img = fluid.layers.data(name="img", shape=list(image_shape),
                            dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    prediction = se_resnext_imagenet(img, class_dim=class_dim, depth=depth)
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=prediction, label=label))
    acc = fluid.layers.accuracy(input=prediction, label=label)
    if lr is not None:
        fluid.optimizer.Momentum(learning_rate=lr, momentum=0.9).minimize(loss)
    return img, label, prediction, loss, acc
