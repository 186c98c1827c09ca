"""Weight-decay regularizers (counterpart of
``paddle_tpu/fluid/regularizer.py``).  L2 decay emits ``scale`` + ``sum``,
both ported (a sparse table's SelectedRows grad is scatter-added into the
dense decay by ``sum``, as in the reference); L1 decay's ``sign`` op is not
registered yet."""

from __future__ import annotations

from .framework import OpRole

__all__ = ["append_regularization_ops", "L1Decay", "L2Decay",
           "L1DecayRegularizer", "L2DecayRegularizer"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff,
                               OpRole.KEY: OpRole.Backward})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="sign", inputs={"X": [param]},
                        outputs={"Out": [sign]},
                        attrs={OpRole.KEY: OpRole.Backward})
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self._regularization_coeff,
                               OpRole.KEY: OpRole.Backward})
        return decay


def _create_regularization_of_grad(param, grad, regularization=None):
    regularizer = getattr(param, "regularizer", None) or regularization
    if regularizer is None:
        return grad
    block = grad.block
    decay = regularizer(param, grad, block)
    new_grad = block.create_var(name=grad.name + "_regularized",
                                dtype=grad.dtype, shape=grad.shape)
    block.append_op(type="sum", inputs={"X": [grad, decay]},
                    outputs={"Out": [new_grad]},
                    attrs={OpRole.KEY: OpRole.Backward})
    return new_grad


def append_regularization_ops(parameters_and_grads, regularization=None):
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        new_grad = _create_regularization_of_grad(param, grad, regularization)
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
