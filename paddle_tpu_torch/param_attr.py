"""ParamAttr: parameter configuration bundle.

Reference parity: paddle_tpu/param_attr.py (fluid param_attr.py).
"""
from .initializer import ConstantInitializer, Initializer, XavierInitializer

__all__ = ['ParamAttr']


class ParamAttr(object):
    def __init__(self,
                 name=None,
                 initializer=None,
                 learning_rate=1.0,
                 regularizer=None,
                 trainable=True,
                 gradient_clip=None):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip

    def set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    def set_default_param_initializer(self):
        self.set_default_initializer(XavierInitializer())

    def set_default_bias_initializer(self):
        self.set_default_initializer(ConstantInitializer(0.0))

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, (float, int)):
            return ParamAttr(learning_rate=float(arg))
        raise TypeError("cannot interpret %r as ParamAttr" % (arg,))

    def to_kwargs(self):
        return {
            'name': self.name,
            'optimize_attr': {'learning_rate': self.learning_rate},
            'regularizer': self.regularizer,
            'trainable': self.trainable,
            'gradient_clip_attr': self.gradient_clip,
        }
