"""Optimizers (counterpart of ``paddle_tpu/fluid/optimizer.py``, copied so
both packages build the same update ops): ``minimize`` = append_backward +
clip + regularization + one update op per parameter, with
``OpRole.Optimize``.  The port's Executor runs the update ops eagerly and
updates the parameters and moments in place.

Only ``adam`` has an op in the port so far; the other optimizers build,
and their ops raise ``NotImplementedError`` when run.  Not ported yet:
``ModelAverage``, LARS weight decay and AMP loss scaling.
"""

from __future__ import annotations

from collections import defaultdict

from . import unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .framework import OpRole, Program, Variable, default_main_program, \
    default_startup_program, program_guard
from .initializer import ConstantInitializer
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["SGD", "Momentum", "Adagrad", "Adam", "Adamax", "DecayedAdagrad",
           "Adadelta", "RMSProp", "Ftrl", "SGDOptimizer", "MomentumOptimizer",
           "AdagradOptimizer", "AdamOptimizer", "AdamaxOptimizer",
           "DecayedAdagradOptimizer", "AdadeltaOptimizer", "RMSPropOptimizer",
           "FtrlOptimizer", "Optimizer",
    "ProximalGDOptimizer", "ProximalAdagradOptimizer", "ProximalGD",
    "ProximalAdagrad",
]


class Optimizer:
    def __init__(self, learning_rate, regularization=None, name=None,
                 LARS_weight_decay=0.0):
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None
        self._LARS_weight_decay = float(LARS_weight_decay)
        if self._LARS_weight_decay > 0.0:
            raise NotImplementedError("LARS weight decay is not ported yet")

    # -- learning rate plumbing --
    def _create_global_learning_rate(self):
        program = default_main_program()
        lr = self._learning_rate_map.get(program)
        if lr is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program] = self._learning_rate
            return
        from .layers import tensor as _tensor

        self._learning_rate_map[program] = _tensor.create_global_var(
            name=unique_name.generate("learning_rate"), shape=[1],
            value=float(self._learning_rate), dtype="float32",
            persistable=True)

    def _global_learning_rate(self, program=None):
        program = program or default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = (param.optimize_attr or {}).get("learning_rate", 1.0)
        if not isinstance(param_lr, (int, float)):
            # a Variable: used as the lr as it is
            return param_lr
        base = self._global_learning_rate()
        if param_lr == 1.0:
            return base
        from .layers import nn as _nn

        return _nn.scale(base, scale=float(param_lr))

    # -- accumulators --
    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0,
                         shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        if shape is None:
            shape = list(param.shape)
        var = self.helper.create_global_variable(
            name=unique_name.generate(name + "_" + param.name),
            persistable=True, dtype=dtype or param.dtype, shape=shape)
        self.helper.set_variable_initializer(
            var, ConstantInitializer(float(fill_value)))
        self._accumulators[name][param.name] = var
        # accumulator -> param registry on the Program, as the reference
        # keeps it
        prog = var.block.program
        if not hasattr(prog, "_accumulator_owner"):
            prog._accumulator_owner = {}
        prog._accumulator_owner[var.name] = param.name
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block):
        pass

    # -- the pass --
    def _create_optimization_pass(self, parameters_and_grads, loss,
                                  startup_program=None):
        program = loss.block.program
        with program_guard(program, startup_program or
                           default_startup_program()):
            self.helper = LayerHelper(self.__class__.__name__)
            self._create_global_learning_rate()
            self._create_accumulators(
                program.global_block(),
                [p for p, g in parameters_and_grads if g is not None])
            optimize_ops = []
            for param_and_grad in parameters_and_grads:
                if param_and_grad[1] is None:
                    continue
                if getattr(param_and_grad[0], "trainable", True):
                    op = self._append_optimize_op(program.global_block(),
                                                  param_and_grad)
                    op.attrs[OpRole.KEY] = OpRole.Optimize
                    op.attrs[OpRole.VAR_KEY] = [param_and_grad[0].name,
                                                param_and_grad[1].name]
                    optimize_ops.append(op)
            self._finish_update(program.global_block())
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set,
                                       [error_clip_callback])
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        optimize_ops = self._create_optimization_pass(params_grads, loss,
                                                      startup_program)
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]})


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity = self._get_accumulator(self._velocity_acc_str,
                                         param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Velocity": [velocity],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon})


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_mode=False, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p, shape=[1],
                                  fill_value=self._beta1)
            self._add_accumulator(self._beta2_pow_acc_str, p, shape=[1],
                                  fill_value=self._beta2)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        m1 = self._get_accumulator(self._moment1_acc_str, p)
        m2 = self._get_accumulator(self._moment2_acc_str, p)
        b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
        b2p = self._get_accumulator(self._beta2_pow_acc_str, p)
        return block.append_op(
            type=self.type,
            inputs={"Param": [p], "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(self._beta1_pow_acc_str, p, shape=[1],
                                  fill_value=self._beta1)

    def _append_optimize_op(self, block, param_and_grad):
        p = param_and_grad[0]
        moment = self._get_accumulator(self._moment_acc_str, p)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, p)
        b1p = self._get_accumulator(self._beta1_pow_acc_str, p)
        op = block.append_op(
            type=self.type,
            inputs={"Param": [p], "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)],
                    "Moment": [moment], "InfNorm": [inf_norm],
                    "Beta1Pow": [b1p]},
            outputs={"ParamOut": [p], "MomentOut": [moment],
                     "InfNormOut": [inf_norm]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})
        return op

    def _finish_update(self, block):
        """Update beta1 power accumulators after all param updates."""
        for p_name, b1p in self._accumulators[self._beta1_pow_acc_str].items():
            block.append_op(type="scale", inputs={"X": [b1p]},
                            outputs={"Out": [b1p]},
                            attrs={"scale": self._beta1,
                                   OpRole.KEY: OpRole.Optimize})


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [moment],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        asg = self._get_accumulator(self._avg_squared_grad_acc_str,
                                    param_and_grad[0])
        asu = self._get_accumulator(self._avg_squared_update_acc_str,
                                    param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "AvgSquaredGrad": [asg], "AvgSquaredUpdate": [asu]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "AvgSquaredGradOut": [asg], "AvgSquaredUpdateOut": [asu]},
            attrs={"epsilon": self._epsilon, "rho": self._rho})


class RMSPropOptimizer(Optimizer):
    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        momentum_acc = self._get_accumulator(self._momentum_acc_str,
                                             param_and_grad[0])
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str,
                                                param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "Moment": [momentum_acc], "MeanSquare": [mean_square_acc],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]],
                     "MomentOut": [momentum_acc],
                     "MeanSquareOut": [mean_square_acc]},
            attrs={"epsilon": self._epsilon, "decay": self._rho,
                   "momentum": self._momentum})


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        sq = self._get_accumulator(self._squared_acc_str, param_and_grad[0])
        lin = self._get_accumulator(self._linear_acc_str, param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]], "Grad": [param_and_grad[1]],
                    "SquaredAccumulator": [sq], "LinearAccumulator": [lin],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power})


class ProximalGDOptimizer(Optimizer):
    """ref: optimizer.py ProximalGDOptimizer / proximal_gd_op.*"""

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "proximal_gd"
        self._l1 = l1
        self._l2 = l2

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]]},
            attrs={"l1": self._l1, "l2": self._l2})


class ProximalAdagradOptimizer(Optimizer):
    """ref: optimizer.py ProximalAdagradOptimizer / proximal_adagrad_op.*"""
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, **kwargs):
        super().__init__(learning_rate, **kwargs)
        self.type = "proximal_adagrad"
        self._l1 = l1
        self._l2 = l2

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        m = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type=self.type,
            inputs={"Param": [param_and_grad[0]],
                    "Grad": [param_and_grad[1]], "Moment": [m],
                    "LearningRate": [self._create_param_lr(param_and_grad)]},
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [m]},
            attrs={"l1": self._l1, "l2": self._l2})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
ProximalGD = ProximalGDOptimizer
ProximalAdagrad = ProximalAdagradOptimizer
