"""ParamAttr (counterpart of ``paddle_tpu/fluid/param_attr.py``)."""

from __future__ import annotations

from .initializer import ConstantInitializer, XavierInitializer


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, gradient_clip=None,
                 do_model_average=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average

    @staticmethod
    def _to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr._to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, bool):
            return ParamAttr._to_attr(None) if arg else False
        if hasattr(arg, "__call__"):  # bare initializer
            return ParamAttr(initializer=arg)
        raise TypeError(f"cannot make ParamAttr from {arg!r}")

    def _set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    def _set_default_param_initializer(self):
        self._set_default_initializer(XavierInitializer())

    def _set_default_bias_initializer(self):
        self._set_default_initializer(ConstantInitializer(0.0))

    def _to_kwargs(self, with_initializer=False):
        kwargs = {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
        }
        if with_initializer:
            kwargs["initializer"] = self.initializer
        return kwargs
