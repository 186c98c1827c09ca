"""The port's op registry against the JAX package's, by name: the port has
no op type the reference lacks, and holds every one of the one-line
activation, math, reduce and shape ops (63) and of the convolution,
norm, pooling-with-index and random ops (22), of the misc, quant and
metric ops (31), of the remaining optimizer ops with
``average_accumulates`` (8) and of the layer-stack, pipeline and MoE ops
(4), each in its module with the reference's registry flags.
The op types still to port are printed (``pytest -s``): none since the
layer stacks."""

from paddle_tpu.ops.registry import REGISTRY as REF
from paddle_tpu_torch.ops.registry import REGISTRY as PORT

ONE_LINE_OPS = {
    "activation_ops": [
        "abs", "sqrt", "rsqrt", "reciprocal", "round", "sin", "softplus",
        "softsign", "softshrink", "gelu", "logsigmoid", "tanh_shrink",
        "relu6", "leaky_relu", "elu", "pow", "stanh", "hard_sigmoid",
        "hard_shrink", "thresholded_relu", "soft_relu", "brelu", "swish",
        "prelu", "log_softmax"],
    "math_ops": [
        "clip", "clip_by_norm", "isfinite", "has_inf", "has_nan", "sign",
        "maximum", "minimum", "dot", "elementwise_mod",
        "elementwise_floordiv"],
    "reduce_ops": [
        "reduce_max", "reduce_min", "reduce_prod", "cumsum", "arg_max",
        "arg_min", "argsort"],
    "shape_ops": [
        "reshape2", "transpose2", "squeeze", "unsqueeze", "stack", "unstack",
        "expand", "expand_as", "scatter", "pad", "pad2d",
        "pad_constant_like", "crop", "reverse", "shape", "multiplex",
        "where", "tile", "bilinear_interp", "nearest_interp"],
}

TRANCHE6_OPS = {
    "nn_ops": [
        "conv3d", "depthwise_conv2d", "conv2d_transpose", "conv3d_transpose",
        "lrn", "maxout", "group_norm", "spp", "pool3d",
        "max_pool2d_with_index", "max_pool3d_with_index", "unpool",
        "scale_sub_region", "print"],
    "misc_ops": ["depthwise_conv2d_transpose"],
    "random_ops": [
        "fill_zeros_like", "uniform_random_batch_size_like",
        "gaussian_random_batch_size_like", "truncated_gaussian_random",
        "sampling_id", "shuffle_channel", "range"],
}


TRANCHE7_OPS = {
    "misc_ops": [
        "minus", "cos_sim", "l1_norm", "norm", "bilinear_tensor_product",
        "conv_shift", "modified_huber_loss", "label_smooth", "fill",
        "random_crop", "flatten2", "squeeze2", "unsqueeze2", "extract_rows",
        "split_ids", "merge_ids", "split_selected_rows", "save", "load",
        "save_combine", "load_combine", "delete_var", "get_places"],
    "quant_ops": [
        "dequantize_weight", "fake_quantize_abs_max",
        "fake_quantize_range_abs_max", "fake_dequantize_max_abs"],
    "metric_ops": ["auc", "mean_iou", "positive_negative_pair",
                   "precision_recall"],
}

OPTIMIZER_OPS = ["adagrad", "adamax", "decayed_adagrad", "adadelta", "ftrl",
                 "proximal_gd", "proximal_adagrad", "average_accumulates"]


def test_port_has_no_op_the_reference_lacks():
    assert sorted(set(PORT) - set(REF)) == []


def test_one_line_ops_are_ported_in_their_modules():
    names = [n for ops in ONE_LINE_OPS.values() for n in ops]
    assert len(names) == len(set(names)) == 63
    for module, ops in ONE_LINE_OPS.items():
        for name in ops:
            assert name in PORT, name
            assert PORT[name].fn.__module__ == \
                f"paddle_tpu_torch.ops.{module}", (name, PORT[name].fn)
            assert PORT[name].no_grad_inputs == REF[name].no_grad_inputs, name


def test_tranche6_ops_are_ported_in_their_modules_with_reference_flags():
    names = [n for ops in TRANCHE6_OPS.values() for n in ops]
    assert len(names) == len(set(names)) == 22
    for module, ops in TRANCHE6_OPS.items():
        for name in ops:
            assert name in PORT, name
            assert PORT[name].fn.__module__ == \
                f"paddle_tpu_torch.ops.{module}", (name, PORT[name].fn)
            assert PORT[name].no_grad_inputs == REF[name].no_grad_inputs, name
            assert PORT[name].stateful == REF[name].stateful, name


def test_tranche7_ops_are_ported_in_their_modules_with_reference_flags():
    """And an explicit grad exactly where the reference registers one (the
    quantizers' straight-through grads)."""
    names = [n for ops in TRANCHE7_OPS.values() for n in ops]
    assert len(names) == len(set(names)) == 31
    for module, ops in TRANCHE7_OPS.items():
        for name in ops:
            assert PORT[name].fn.__module__ == \
                f"paddle_tpu_torch.ops.{module}", (name, PORT[name].fn)
            assert PORT[name].no_grad_inputs == REF[name].no_grad_inputs, name
            assert PORT[name].stateful == REF[name].stateful, name
            assert (PORT[name].grad_fn is None) == \
                (REF[name].grad_fn is None), name


def test_optimizer_ops_are_ported_with_reference_flags_and_groups():
    """And each registers a group impl, which the Executor hands a run of
    them (the reference has none: XLA fuses its whole step)."""
    assert len(set(OPTIMIZER_OPS)) == 8
    for name in OPTIMIZER_OPS:
        assert PORT[name].fn.__module__ == \
            "paddle_tpu_torch.ops.optimizer_ops", (name, PORT[name].fn)
        assert PORT[name].no_grad_inputs == REF[name].no_grad_inputs, name
        assert PORT[name].stateful == REF[name].stateful, name
        assert (PORT[name].grad_fn is None) == \
            (REF[name].grad_fn is None), name
        assert PORT[name].group_fn is not None, name


def test_tranche6_convolutions_have_explicit_grads():
    for name in ("conv2d", "conv3d", "depthwise_conv2d", "conv2d_transpose",
                 "conv3d_transpose", "depthwise_conv2d_transpose",
                 "max_pool2d_with_index", "max_pool3d_with_index"):
        assert PORT[name].grad_fn is not None, name


STACK_OPS = {
    "transformer_ops": ["transformer_encoder_stack",
                        "transformer_decoder_stack"],
    "pipeline_ops": ["gpipe_mlp_stack"],
    "moe_ops": ["moe_ffn"],
}


def test_stack_pipeline_and_moe_ops_are_ported_with_reference_flags():
    """The stack ops draw dropout masks (stateful) and have explicit grads;
    the other two take the generic grad, as in the reference."""
    for module, ops in STACK_OPS.items():
        for name in ops:
            assert PORT[name].fn.__module__ == \
                f"paddle_tpu_torch.ops.{module}", (name, PORT[name].fn)
            assert PORT[name].no_grad_inputs == REF[name].no_grad_inputs, name
            assert PORT[name].stateful == REF[name].stateful, name
            assert (PORT[name].grad_fn is None) == \
                (REF[name].grad_fn is None), name
    assert PORT["transformer_encoder_stack"].stateful
    assert PORT["moe_ffn"].grad_fn is None


def test_missing_op_types_are_listed():
    missing = sorted(set(REF) - set(PORT))
    print(f"\n{len(PORT)} of {len(REF)} op types ported; {len(missing)} "
          f"still to port: {', '.join(missing)}")
    assert len(PORT) + len(missing) == len(REF)
    assert len(PORT) == 273 and len(missing) == 0
