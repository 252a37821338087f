"""Optimizers: SGD, Momentum, Adam.

Reference parity: paddle_tpu/optimizer.py (fluid optimizer.py).
``minimize`` = autodiff (core/backward.py) + one update op per parameter
+ Adam's beta-pow ``scale`` ops, with the reference's op attrs, variable
names and startup ops.  Regularization and gradient clip raise: they come
with a later slice.
"""
from collections import defaultdict

from .core.backward import append_backward
from .core.program import Variable, default_startup_program, unique_name
from .initializer import ConstantInitializer
from .layers.layer_helper import LayerHelper

__all__ = ['Optimizer', 'SGDOptimizer', 'MomentumOptimizer',
           'AdamOptimizer', 'SGD', 'Momentum', 'Adam']

_LATER = ("not ported yet: ROADMAP.md Queue 1, gradient clip and "
          "regularizers")


class Optimizer(object):
    """Base optimizer.  Subclasses set ``type`` (the update op) and
    implement _append_optimize_op."""

    type = None

    def __init__(self, learning_rate, global_step=None, regularization=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning rate should be float or Variable")
        if regularization is not None:
            raise NotImplementedError("optimizer regularization is " + _LATER)
        if global_step is not None:
            raise NotImplementedError(
                "global_step needs the `increment` op, not ported yet: "
                "ROADMAP.md Queue 1")
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = defaultdict(dict)
        self.helper = None

    def _create_global_learning_rate(self, program):
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[program._uid] = self._learning_rate
            return
        if program._uid in self._learning_rate_map:
            return
        from .layers.tensor import create_global_var
        lr = create_global_var(
            name=unique_name("learning_rate"),
            shape=[1], value=float(self._learning_rate),
            dtype='float32', persistable=True)
        self._learning_rate_map[program._uid] = lr

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = param.optimize_attr['learning_rate'] \
            if getattr(param, 'optimize_attr', None) else 1.0
        lr = self._learning_rate_map[param.block.program._uid]
        if param_lr == 1.0:
            return lr
        from .layers import ops as layer_ops
        return layer_ops.scale(lr, scale=param_lr)

    def _add_accumulator(self, name, param, dtype='float32',
                         fill_value=0.0, shape=None):
        if param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        var = self.helper.create_global_variable(
            name=unique_name(param.name + "_" + name), persistable=True,
            shape=shape or param.shape, dtype=dtype)
        self.helper.set_variable_initializer(
            var, ConstantInitializer(fill_value))
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def create_optimization_pass(self, parameters_and_grads, loss,
                                 startup_program=None):
        program = loss.block.program
        block = program.global_block()
        self.helper = LayerHelper(
            self.__class__.__name__,
            main_program=program,
            startup_program=startup_program or default_startup_program())
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None])
        self._create_global_learning_rate(program)
        optimize_ops = []
        with program.op_role_guard('optimize'):
            for param_and_grad in parameters_and_grads:
                if param_and_grad[1] is None:
                    continue
                if getattr(param_and_grad[0], 'trainable', True):
                    optimize_ops.append(
                        self._append_optimize_op(block, param_and_grad))
            self._finish_update(block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        for p in loss.block.program.all_parameters():
            if getattr(p, 'regularizer', None) is not None:
                raise NotImplementedError(
                    "parameter regularizer on %r is %s" % (p.name, _LATER))
            if getattr(p, 'gradient_clip_attr', None) is not None:
                raise NotImplementedError(
                    "gradient clip on %r is %s" % (p.name, _LATER))
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        optimize_ops = self.create_optimization_pass(
            params_grads, loss, startup_program)
        return optimize_ops, params_grads

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    type = 'sgd'

    def _append_optimize_op(self, block, param_and_grad):
        return self.helper.append_op(
            type='sgd',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]]},
            attrs={},
            infer_shape=False)


class MomentumOptimizer(Optimizer):
    type = 'momentum'
    _velocity_acc_str = 'velocity'

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 **kwargs):
        super(MomentumOptimizer, self).__init__(learning_rate, **kwargs)
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity_acc = self._get_accumulator(self._velocity_acc_str,
                                             param_and_grad[0])
        return self.helper.append_op(
            type='momentum',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Velocity': [velocity_acc],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'VelocityOut': [velocity_acc]},
            attrs={'mu': self._momentum,
                   'use_nesterov': self._use_nesterov},
            infer_shape=False)


class AdamOptimizer(Optimizer):
    type = 'adam'
    _moment1_acc_str = 'moment1'
    _moment2_acc_str = 'moment2'

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamOptimizer, self).__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
        self._beta1_pow_acc = self.helper.create_global_variable(
            name=unique_name('beta1_pow_acc'), persistable=True,
            shape=[1], dtype='float32')
        self.helper.set_variable_initializer(
            self._beta1_pow_acc, ConstantInitializer(self._beta1))
        self._beta2_pow_acc = self.helper.create_global_variable(
            name=unique_name('beta2_pow_acc'), persistable=True,
            shape=[1], dtype='float32')
        self.helper.set_variable_initializer(
            self._beta2_pow_acc, ConstantInitializer(self._beta2))

    def _append_optimize_op(self, block, param_and_grad):
        moment1 = self._get_accumulator(self._moment1_acc_str,
                                        param_and_grad[0])
        moment2 = self._get_accumulator(self._moment2_acc_str,
                                        param_and_grad[0])
        return self.helper.append_op(
            type='adam',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'LearningRate': [self._create_param_lr(param_and_grad)],
                    'Moment1': [moment1], 'Moment2': [moment2],
                    'Beta1Pow': [self._beta1_pow_acc],
                    'Beta2Pow': [self._beta2_pow_acc]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'Moment1Out': [moment1], 'Moment2Out': [moment2]},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon},
            infer_shape=False)

    def _finish_update(self, block):
        self.helper.append_op(
            type='scale', inputs={'X': [self._beta1_pow_acc]},
            outputs={'Out': [self._beta1_pow_acc]},
            attrs={'scale': self._beta1}, infer_shape=False)
        self.helper.append_op(
            type='scale', inputs={'X': [self._beta2_pow_acc]},
            outputs={'Out': [self._beta2_pow_acc]},
            attrs={'scale': self._beta2}, infer_shape=False)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
