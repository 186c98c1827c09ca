"""VGG (counterpart of ``paddle_tpu/models/vgg.py``, built call for call):
VGG-16 with batch norm and dropout, ``fluid_benchmark.py``'s ``vgg``;
``depth=19`` adds the fourth convolution to each late block.  Each block
is one ``fluid.nets.img_conv_group``."""

from __future__ import annotations

from .. import fluid

# conv counts per block (Simonyan & Zisserman table 1)
_BLOCKS = {16: (2, 2, 3, 3, 3), 19: (2, 2, 4, 4, 4)}


def vgg_bn_drop(input, class_dim=1000, depth=16):
    def conv_block(inp, num_filter, groups, drop):
        # dropout after every conv+bn except the last of the block
        return fluid.nets.img_conv_group(
            input=inp, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=[drop] * (groups - 1) + [0.0],
            pool_type="max")

    g = _BLOCKS[depth]
    conv1 = conv_block(input, 64, g[0], 0.3)
    conv2 = conv_block(conv1, 128, g[1], 0.4)
    conv3 = conv_block(conv2, 256, g[2], 0.4)
    conv4 = conv_block(conv3, 512, g[3], 0.4)
    conv5 = conv_block(conv4, 512, g[4], 0.4)

    drop = fluid.layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = fluid.layers.fc(input=drop, size=512, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act="relu")
    drop2 = fluid.layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = fluid.layers.fc(input=drop2, size=512, act=None)
    prediction = fluid.layers.fc(input=fc2, size=class_dim, act="softmax")
    return prediction


def vgg16_bn_drop(input, class_dim=1000):
    return vgg_bn_drop(input, class_dim, depth=16)


def build(class_dim=10, image_shape=(3, 32, 32), lr=0.01, depth=16):
    """Returns (img, label, prediction, loss, acc); Adam(lr) minimizes the
    loss."""
    img = fluid.layers.data(name="img", shape=list(image_shape),
                            dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    prediction = vgg_bn_drop(img, class_dim, depth=depth)
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=prediction, label=label))
    acc = fluid.layers.accuracy(input=prediction, label=label)
    opt = fluid.optimizer.Adam(learning_rate=lr)
    opt.minimize(loss)
    return img, label, prediction, loss, acc
