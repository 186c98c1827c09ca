"""MNIST models (counterpart of ``paddle_tpu/models/mnist.py``): the MLP of
the book chapter recognize_digits.  The LeNet-style ``cnn`` needs
``fluid.nets``, which is not ported yet."""

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
    raise NotImplementedError(
        "models.mnist.cnn needs fluid.nets (simple_img_conv_pool), which "
        "paddle_tpu_torch does not port yet")
