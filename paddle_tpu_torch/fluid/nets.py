"""Composite nets (counterpart of ``paddle_tpu/fluid/nets.py``):
``simple_img_conv_pool``, ``img_conv_group``, ``glu`` and
``scaled_dot_product_attention``, builders over ``fluid.layers`` that emit
the reference's ops call for call.  ``sequence_conv_pool`` needs the
sequence ops, which are not ported yet."""

from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "glu",
           "sequence_conv_pool", "scaled_dot_product_attention"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, pool_padding=0, pool_type="max",
                         global_pooling=False, conv_stride=1, conv_padding=0,
                         conv_dilation=1, conv_groups=1, param_attr=None,
                         bias_attr=None, act=None, use_cudnn=True):
    conv_out = layers.conv2d(
        input=input, num_filters=num_filters, filter_size=filter_size,
        stride=conv_stride, padding=conv_padding, dilation=conv_dilation,
        groups=conv_groups, param_attr=param_attr, bias_attr=bias_attr,
        act=act, use_cudnn=use_cudnn)
    return layers.pool2d(
        input=conv_out, pool_size=pool_size, pool_type=pool_type,
        pool_stride=pool_stride, pool_padding=pool_padding,
        global_pooling=global_pooling, use_cudnn=use_cudnn)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True):
    """Convolutions (each optionally followed by batch norm, its ``act``
    and dropout), then one pooling: the VGG block."""
    if not isinstance(conv_num_filter, (list, tuple)):
        raise TypeError("conv_num_filter must be a list or tuple")

    def _ext(v):
        if not hasattr(v, "__len__"):
            return [v] * len(conv_num_filter)
        return list(v)

    conv_padding = _ext(conv_padding)
    conv_filter_size = _ext(conv_filter_size)
    param_attr = _ext(param_attr)
    conv_with_batchnorm = _ext(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _ext(conv_batchnorm_drop_rate)

    tmp = input
    for i in range(len(conv_num_filter)):
        local_conv_act = None if conv_with_batchnorm[i] else conv_act
        tmp = layers.conv2d(
            input=tmp, num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i], padding=conv_padding[i],
            param_attr=param_attr[i], act=local_conv_act, use_cudnn=use_cudnn)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride,
                         use_cudnn=use_cudnn)


def glu(input, dim=-1):
    """Gated linear unit: the first half of ``input`` along ``dim`` times
    the sigmoid of the second."""
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    return layers.elementwise_mul(a, layers.sigmoid(b))


def scaled_dot_product_attention(queries, keys, values, num_heads=1,
                                 dropout_rate=0.0):
    """Multi-head scaled dot-product attention over ``[batch, seq, dim]``
    inputs, as the unfused chain (scale, matmul, softmax, dropout,
    matmul); the flash kernels are reached through
    ``layers.ring_attention``."""
    if len(queries.shape) != 3 or len(keys.shape) != 3 \
            or len(values.shape) != 3:
        raise ValueError("inputs must be 3-D [batch, seq, dim]")

    def _split_heads(x, n):
        if n == 1:
            return x
        hidden = x.shape[-1]
        reshaped = layers.reshape(
            x, shape=[x.shape[0] if x.shape[0] not in (-1, None) else -1,
                      x.shape[1], n, hidden // n])
        return layers.transpose(reshaped, perm=[0, 2, 1, 3])

    def _combine_heads(x):
        if len(x.shape) == 3:
            return x
        t = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            t, shape=[t.shape[0] if t.shape[0] not in (-1, None) else -1,
                      t.shape[1], t.shape[2] * t.shape[3]])

    q = _split_heads(queries, num_heads)
    k = _split_heads(keys, num_heads)
    v = _split_heads(values, num_heads)
    key_dim = float(queries.shape[-1] // num_heads)
    scaled_q = layers.scale(q, scale=key_dim ** -0.5)
    product = layers.matmul(scaled_q, k, transpose_y=True)
    weights = layers.softmax(product)
    if dropout_rate:
        weights = layers.dropout(weights, dropout_prob=dropout_rate)
    ctx_multiheads = layers.matmul(weights, v)
    return _combine_heads(ctx_multiheads)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    raise NotImplementedError(
        "nets.sequence_conv_pool needs sequence_conv and sequence_pool over "
        "LoD tensors, which are not ported yet: ROADMAP.md queue 1 item 8")
