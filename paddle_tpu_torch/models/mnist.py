"""MNIST models (counterpart of ``paddle_tpu/models/mnist.py``): the MLP of
the book chapter recognize_digits (``fluid_benchmark.py``'s ``mnist``), and
the LeNet-style ``cnn``, the ``cnn_model`` of upstream
``benchmark/fluid/mnist.py`` (two ``fluid.nets.simple_img_conv_pool``
blocks)."""

from __future__ import annotations

from .. import fluid


def mlp(img=None, label=None, hidden_sizes=(128, 64), class_num=10):
    if img is None:
        img = fluid.layers.data(name="img", shape=[784], dtype="float32")
    if label is None:
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    hidden = img
    for size in hidden_sizes:
        hidden = fluid.layers.fc(input=hidden, size=size, act="relu")
    prediction = fluid.layers.fc(input=hidden, size=class_num, act="softmax")
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=prediction, label=label))
    acc = fluid.layers.accuracy(input=prediction, label=label)
    return img, label, prediction, loss, acc


def cnn(img=None, label=None, class_num=10):
    """LeNet-5-style conv net (``benchmark/fluid/mnist.py`` cnn_model)."""
    if img is None:
        img = fluid.layers.data(name="img", shape=[1, 28, 28], dtype="float32")
    if label is None:
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    conv1 = fluid.nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2, pool_stride=2,
        act="relu")
    conv2 = fluid.nets.simple_img_conv_pool(
        input=conv1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")
    prediction = fluid.layers.fc(input=conv2, size=class_num, act="softmax")
    loss = fluid.layers.mean(
        fluid.layers.cross_entropy(input=prediction, label=label))
    acc = fluid.layers.accuracy(input=prediction, label=label)
    return img, label, prediction, loss, acc
