"""Parameter initializers: Constant, Uniform, Normal, TruncatedNormal,
Xavier, MSRA.

Reference parity: paddle_tpu/initializer.py (fluid initializer.py).
Each appends its init op for the variable to the startup program block,
with the reference's attrs, so both packages build the same startup
program.
"""
import numpy as np

__all__ = ['Initializer', 'Constant', 'Uniform', 'Normal', 'Xavier', 'MSRA',
           'ConstantInitializer', 'UniformInitializer', 'NormalInitializer',
           'XavierInitializer', 'MSRAInitializer', 'TruncatedNormal']


class Initializer(object):
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _fans(var):
        shape = var.shape
        if len(shape) < 2:
            return int(np.prod(shape)), int(np.prod(shape))
        fan_in = int(np.prod(shape[1:]))
        fan_out = int(shape[0] * np.prod(shape[2:]))
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def __call__(self, var, block):
        return block.append_op(
            type='fill_constant',
            outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'value': float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        return block.append_op(
            type='uniform_random',
            outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'min': self.low, 'max': self.high, 'seed': self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type='gaussian_random',
            outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'mean': self.loc, 'std': self.scale, 'seed': self.seed})


class TruncatedNormal(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        return block.append_op(
            type='truncated_gaussian_random',
            outputs={'Out': [var.name]},
            attrs={'shape': list(var.shape), 'dtype': var.dtype,
                   'mean': self.loc, 'std': self.scale, 'seed': self.seed})


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.fan_out = fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = self._fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / (fi + fo)))
        return NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, var, block):
        fi, _ = self._fans(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = float(np.sqrt(6.0 / fi))
            return UniformInitializer(-limit, limit, self.seed)(var, block)
        std = float(np.sqrt(2.0 / fi))
        return NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
