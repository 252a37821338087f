"""Weight-decay regularizers.

Reference parity: paddle_tpu/regularizer.py (fluid regularizer.py): ops
that add each parameter's decay term to its gradient, ``<grad>_reg`` by a
``sum`` op, before the optimizer op reads it.  SGD folds a dense L2 decay
into its ``sgd`` op instead (optimizer.py ``SGDOptimizer``).
"""
from .core.program import grad_var_name

__all__ = ['append_regularization_ops', 'WeightDecayRegularizer',
           'L1DecayRegularizer', 'L2DecayRegularizer', 'L1Decay', 'L2Decay']


class WeightDecayRegularizer(object):
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    """coeff * param (one ``scale`` op)."""

    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op(type='scale', inputs={'X': [param]},
                        outputs={'Out': [decay]},
                        attrs={'scale': self._regularization_coeff})
        return decay


class L1DecayRegularizer(WeightDecayRegularizer):
    """coeff * sign(param) (``sign``, then ``scale``)."""

    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op(type='sign', inputs={'X': [param]},
                        outputs={'Out': [sign]})
        decay = block.create_var(shape=param.shape, dtype=param.dtype)
        block.append_op(type='scale', inputs={'X': [sign]},
                        outputs={'Out': [decay]},
                        attrs={'scale': self._regularization_coeff})
        return decay


def append_regularization_ops(parameters_and_grads, regularization=None):
    """[(param, grad)] -> [(param, grad + decay)]: a parameter's own
    regularizer, else ``regularization``, else the gradient as it is."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        term = None
        if getattr(param, 'regularizer', None) is not None:
            term = param.regularizer(param, grad, grad.block)
        elif regularization is not None:
            term = regularization(param, grad, grad.block)
        if grad is None or term is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        new_grad = block.create_var(
            name=grad_var_name(param.name) + '_reg', shape=param.shape,
            dtype=param.dtype)
        new_grad.stop_gradient = True
        block.append_op(type='sum', inputs={'X': [grad, term]},
                        outputs={'Out': [new_grad]})
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
