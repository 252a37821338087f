"""Optimizers: SGD, Momentum, Adam, Adagrad, Adamax, DecayedAdagrad,
Adadelta, RMSProp, Ftrl.

Reference parity: paddle_tpu/optimizer.py (fluid optimizer.py).
``minimize`` = autodiff (core/backward.py), then gradient clip (clip.py)
and the regularizers (regularizer.py) in the backward role, then one
update op per parameter, Adam's beta-pow ``scale`` ops and the
``global_step`` increment, with the reference's op attrs, variable names
and startup ops.  SGD folds a dense float32 gradient's L2 decay into its
``sgd`` op (``weight_decay``, which the dense-update kernel applies).
"""
from collections import defaultdict

from .clip import append_gradient_clip_ops
from .core import datatypes
from .core.backward import append_backward
from .core.program import Variable, default_startup_program, unique_name
from .initializer import ConstantInitializer
from .layers.layer_helper import LayerHelper
from .regularizer import L2DecayRegularizer, append_regularization_ops

__all__ = ['Optimizer', 'SGDOptimizer', 'MomentumOptimizer',
           'AdamOptimizer', 'AdagradOptimizer', 'AdamaxOptimizer',
           'DecayedAdagradOptimizer', 'AdadeltaOptimizer',
           'RMSPropOptimizer', 'FtrlOptimizer', 'SGD', 'Momentum', 'Adam',
           'Adagrad', 'Adamax', 'DecayedAdagrad', 'Adadelta', 'RMSProp',
           'Ftrl']


class Optimizer(object):
    """Base optimizer.  Subclasses set ``type`` (the update op) and
    implement _append_optimize_op."""

    type = None

    def __init__(self, learning_rate, global_step=None, regularization=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning rate should be float or Variable")
        self._global_step = global_step
        self.regularization = regularization
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

    def _increment_global_step(self, block):
        if self._global_step is None:
            return
        self.helper.append_op(
            type='increment', inputs={'X': [self._global_step]},
            outputs={'Out': [self._global_step]}, attrs={'step': 1.0},
            infer_shape=False)

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
            self._increment_global_step(block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        params_grads = append_backward(loss, parameter_list, no_grad_set)
        # clip and regularizer ops transform the gradients after the
        # autodiff op: backward role, run at top level
        with loss.block.program.op_role_guard('backward'):
            params_grads = append_gradient_clip_ops(params_grads)
            params_grads = self._apply_regularization(params_grads)
        optimize_ops = self.create_optimization_pass(
            params_grads, loss, startup_program)
        return optimize_ops, params_grads

    def _apply_regularization(self, params_grads):
        """Weave each parameter's regularizer (or ``regularization``)
        into its gradient; SGD overrides this to fold L2 into its op."""
        return append_regularization_ops(params_grads, self.regularization)

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError


class SGDOptimizer(Optimizer):
    type = 'sgd'

    def _apply_regularization(self, params_grads):
        """Fold L2 decay into the ``sgd`` op (its ``weight_decay`` attr:
        p - lr * (g + wd * p), the expression the weave builds, in one
        pass on the dense-update kernel) for a dense gradient of a
        parameter of float32 or wider.  Everything else keeps the weave:
        a SelectedRows gradient (its row-wise apply never reaches the
        rows the decay must shrink), a low-precision parameter (whose
        woven terms round in its dtype), L1, and per-parameter
        regularizers other than L2."""
        self._fused_decay = {}
        sparse_grads = set()
        gblock = next((g.block for _, g in params_grads if g is not None),
                      None)
        if gblock is not None:
            for op in gblock.ops:
                if op.type == 'sparse_grad_assemble':
                    sparse_grads.update(op.output_arg_names)
        weave = []
        for p, g in params_grads:
            reg = getattr(p, 'regularizer', None)
            if reg is None:
                reg = self.regularization
            if (g is not None and isinstance(reg, L2DecayRegularizer) and
                    reg._regularization_coeff and
                    g.name not in sparse_grads and
                    not datatypes.is_low_precision(p.dtype)):
                self._fused_decay[p.name] = float(reg._regularization_coeff)
            else:
                weave.append((p, g))
        woven = iter(append_regularization_ops(weave, self.regularization))
        return [(p, g) if p.name in self._fused_decay else next(woven)
                for p, g in params_grads]

    def _append_optimize_op(self, block, param_and_grad):
        attrs = {}
        wd = getattr(self, '_fused_decay', {}).get(param_and_grad[0].name)
        if wd:
            attrs['weight_decay'] = wd
        return self.helper.append_op(
            type='sgd',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]]},
            attrs=attrs,
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


class AdagradOptimizer(Optimizer):
    type = 'adagrad'
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, epsilon=1.0e-6, **kwargs):
        super(AdagradOptimizer, self).__init__(learning_rate, **kwargs)
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return self.helper.append_op(
            type='adagrad',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Moment': [moment_acc],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'MomentOut': [moment_acc]},
            attrs={'epsilon': self._epsilon},
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


class AdamaxOptimizer(Optimizer):
    type = 'adamax'
    _moment_acc_str = 'moment'
    _inf_norm_acc_str = 'inf_norm'

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super(AdamaxOptimizer, self).__init__(learning_rate, **kwargs)
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
        self._beta1_pow_acc = self.helper.create_global_variable(
            name=unique_name('beta1_pow_acc'), persistable=True,
            shape=[1], dtype='float32')
        self.helper.set_variable_initializer(
            self._beta1_pow_acc, ConstantInitializer(self._beta1))

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str,
                                       param_and_grad[0])
        inf_norm = self._get_accumulator(self._inf_norm_acc_str,
                                         param_and_grad[0])
        return self.helper.append_op(
            type='adamax',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'LearningRate': [self._create_param_lr(param_and_grad)],
                    'Moment': [moment], 'InfNorm': [inf_norm],
                    'Beta1Pow': [self._beta1_pow_acc]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'MomentOut': [moment], 'InfNormOut': [inf_norm]},
            attrs={'beta1': self._beta1, 'beta2': self._beta2,
                   'epsilon': self._epsilon},
            infer_shape=False)

    def _finish_update(self, block):
        self.helper.append_op(
            type='scale', inputs={'X': [self._beta1_pow_acc]},
            outputs={'Out': [self._beta1_pow_acc]},
            attrs={'scale': self._beta1}, infer_shape=False)


class DecayedAdagradOptimizer(Optimizer):
    type = 'decayed_adagrad'
    _moment_acc_str = 'moment'

    def __init__(self, learning_rate, decay=0.95, epsilon=1.0e-6, **kwargs):
        super(DecayedAdagradOptimizer, self).__init__(learning_rate,
                                                      **kwargs)
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str,
                                           param_and_grad[0])
        return self.helper.append_op(
            type='decayed_adagrad',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'Moment': [moment_acc],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'MomentOut': [moment_acc]},
            attrs={'decay': self._decay, 'epsilon': self._epsilon},
            infer_shape=False)


class AdadeltaOptimizer(Optimizer):
    type = 'adadelta'

    def __init__(self, learning_rate=1.0, rho=0.95, epsilon=1.0e-6,
                 **kwargs):
        super(AdadeltaOptimizer, self).__init__(learning_rate, **kwargs)
        self._rho = rho
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('avg_squared_grad', p)
            self._add_accumulator('avg_squared_update', p)

    def _append_optimize_op(self, block, param_and_grad):
        asg = self._get_accumulator('avg_squared_grad', param_and_grad[0])
        asu = self._get_accumulator('avg_squared_update', param_and_grad[0])
        return self.helper.append_op(
            type='adadelta',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'AvgSquaredGrad': [asg], 'AvgSquaredUpdate': [asu]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'AvgSquaredGradOut': [asg],
                     'AvgSquaredUpdateOut': [asu]},
            attrs={'rho': self._rho, 'epsilon': self._epsilon},
            infer_shape=False)


class RMSPropOptimizer(Optimizer):
    type = 'rmsprop'

    def __init__(self, learning_rate, rho=0.95, epsilon=1.0e-6,
                 momentum=0.0, **kwargs):
        super(RMSPropOptimizer, self).__init__(learning_rate, **kwargs)
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('mean_square', p)
            self._add_accumulator('momentum', p)

    def _append_optimize_op(self, block, param_and_grad):
        ms = self._get_accumulator('mean_square', param_and_grad[0])
        mom = self._get_accumulator('momentum', param_and_grad[0])
        return self.helper.append_op(
            type='rmsprop',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'MeanSquare': [ms], 'Moment': [mom],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'MeanSquareOut': [ms], 'MomentOut': [mom]},
            attrs={'decay': self._rho, 'epsilon': self._epsilon,
                   'momentum': self._momentum},
            infer_shape=False)


class FtrlOptimizer(Optimizer):
    type = 'ftrl'

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 **kwargs):
        super(FtrlOptimizer, self).__init__(learning_rate, **kwargs)
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator('squared', p)
            self._add_accumulator('linear', p)

    def _append_optimize_op(self, block, param_and_grad):
        sq = self._get_accumulator('squared', param_and_grad[0])
        lin = self._get_accumulator('linear', param_and_grad[0])
        return self.helper.append_op(
            type='ftrl',
            inputs={'Param': [param_and_grad[0]],
                    'Grad': [param_and_grad[1]],
                    'SquaredAccumulator': [sq], 'LinearAccumulator': [lin],
                    'LearningRate': [self._create_param_lr(param_and_grad)]},
            outputs={'ParamOut': [param_and_grad[0]],
                     'SquaredAccumOut': [sq], 'LinearAccumOut': [lin]},
            attrs={'l1': self._l1, 'l2': self._l2,
                   'lr_power': self._lr_power},
            infer_shape=False)


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
Adagrad = AdagradOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
