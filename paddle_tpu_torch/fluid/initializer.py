"""Parameter initializers (counterpart of ``paddle_tpu/fluid/initializer.py``).

Each initializer appends the same init op to the startup block as the
reference does.  The port's Executor runs ``uniform_random``,
``gaussian_random`` and ``truncated_gaussian_random`` from a seeded
``torch.Generator``, which gives other numbers than the reference's JAX
threefry draw: tests that compare the two packages copy the reference's
weights across (``models.params.load_reference_params``).
"""

from __future__ import annotations

import math

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "value": float(self._value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low, self._high, self._seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "min": self._low, "max": self._high, "seed": self._seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self._mean, "std": self._std, "seed": self._seed})


class TruncatedNormalInitializer(Initializer):
    """``truncated_gaussian_random``: a normal draw truncated to two
    standard deviations of ``loc``."""

    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean, self._std, self._seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape), "dtype": var.dtype,
                   "mean": self._mean, "std": self._std, "seed": self._seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) < 2:
        return (shape[0] if shape else 1, shape[0] if shape else 1)
    receptive = 1
    for d in shape[2:]:
        receptive *= d
    # paddle convention: fc weight [in, out]; conv filter [out, in, k, k]
    if len(shape) == 2:
        return shape[0], shape[1]
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform, self._fan_in, self._fan_out, self._seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fin, fout = _fan_in_out(var)
        fin = self._fan_in if self._fan_in is not None else fin
        fout = self._fan_out if self._fan_out is not None else fout
        if self._uniform:
            limit = math.sqrt(6.0 / (fin + fout))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = math.sqrt(2.0 / (fin + fout))
        return NormalInitializer(0.0, std, self._seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform, self._fan_in, self._seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fin, _ = _fan_in_out(var)
        fin = self._fan_in if self._fan_in is not None else fin
        if self._uniform:
            limit = math.sqrt(6.0 / fin)
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = math.sqrt(2.0 / fin)
        return NormalInitializer(0.0, std, self._seed)(var, block)


class BilinearInitializer(Initializer):
    """The bilinear upsampling filter of a ``conv2d_transpose`` (4-D
    ``[C_in, C_out / groups, k, k]``), every channel pair the same
    ``k`` x ``k`` tent, emitted as ``assign_value``."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("Bilinear init needs a 4-D filter")
        weight = np.zeros(shape, dtype=np.float32)
        k = shape[3]
        f = int(np.ceil(k / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        for i in range(np.prod(shape)):
            x = i % k
            y = (i // k) % shape[2]
            weight.flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            type="assign_value", outputs={"Out": var},
            attrs={"shape": list(self._value.shape), "dtype": var.dtype,
                   "fp32_values": [float(v) for v in self._value.flat]})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def force_init_on_cpu():
    """False: the startup program's place decides where parameters are
    made, as in the reference."""
    return False


def init_on_cpu():
    """A context manager that does nothing: the startup program's place
    decides where its ops run, so there is no separate CPU init to force
    (the reference's does nothing either)."""
    import contextlib

    @contextlib.contextmanager
    def _noop():
        yield

    return _noop()
