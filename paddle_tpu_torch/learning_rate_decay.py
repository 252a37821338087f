"""Learning-rate decay schedules.

Reference parity: paddle_tpu/learning_rate_decay.py (fluid
learning_rate_decay.py): each schedule builds ops that compute the rate
from a persistable float32 step counter, which an ``increment`` op
advances once a run.  The rate is a one-element float32 tensor on the
executor's device, which the optimizer ops (and the dense-update kernel)
read where it lies: a scheduled rate adds no host sync.
"""
from . import layers
from .core.program import unique_name
from .initializer import ConstantInitializer
from .layers.layer_helper import LayerHelper

__all__ = [
    'exponential_decay', 'natural_exp_decay', 'inverse_time_decay',
    'polynomial_decay', 'piecewise_decay', 'global_step_counter',
]


def global_step_counter(counter_name=None, begin=0, step=1):
    """A persistable float32 counter, ``begin`` at the first run,
    advanced by ``step`` once a run (fluid's
    autoincreased_step_counter)."""
    helper = LayerHelper('global_step_counter')
    name = counter_name or unique_name('@STEP_COUNTER@')
    counter = helper.create_global_variable(
        name=name, dtype='float32', shape=[1], persistable=True)
    helper.set_variable_initializer(
        counter, ConstantInitializer(float(begin - step)))
    helper.append_op(
        type='increment', inputs={'X': [counter]},
        outputs={'Out': [counter]}, attrs={'step': float(step)},
        infer_shape=False)
    counter.stop_gradient = True
    return counter


def _decay_step_counter():
    return global_step_counter(begin=1)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * rate ^ (step / decay_steps), the exponent floored with
    ``staircase``."""
    global_step = _decay_step_counter()
    div_res = layers.scale(x=global_step, scale=1.0 / float(decay_steps))
    if staircase:
        div_res = layers.floor(x=div_res)
    base = layers.fill_constant(shape=[1], dtype='float32',
                                value=float(decay_rate))
    decay = layers.elementwise_pow(x=base, y=div_res)
    return layers.scale(x=decay, scale=float(learning_rate))


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    """lr * exp(-rate * step / decay_steps)."""
    global_step = _decay_step_counter()
    div_res = layers.scale(x=global_step, scale=1.0 / decay_steps)
    if staircase:
        div_res = layers.floor(x=div_res)
    exponent = layers.scale(x=div_res, scale=-float(decay_rate))
    decay = layers.exp(x=exponent)
    return layers.scale(x=decay, scale=float(learning_rate))


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    """lr / (1 + rate * step / decay_steps)."""
    global_step = _decay_step_counter()
    div_res = layers.scale(x=global_step, scale=1.0 / decay_steps)
    if staircase:
        div_res = layers.floor(x=div_res)
    denom = layers.scale(x=div_res, scale=float(decay_rate), bias=1.0)
    one = layers.fill_constant(shape=[1], dtype='float32',
                               value=float(learning_rate))
    return layers.elementwise_div(x=one, y=denom)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    """(lr - end) * (1 - step / decay_steps) ^ power + end, the step held
    at decay_steps, or with ``cycle`` decay_steps grown to the next
    multiple of itself past the step."""
    global_step = _decay_step_counter()
    if cycle:
        periods = layers.ceil(
            x=layers.scale(x=global_step, scale=1.0 / float(decay_steps)))
        periods = layers.elementwise_max(
            x=periods,
            y=layers.fill_constant(shape=[1], dtype='float32', value=1.0))
        steps = layers.scale(x=periods, scale=float(decay_steps))
        frac = layers.elementwise_div(x=global_step, y=steps)
    else:
        gs = layers.elementwise_min(
            x=global_step,
            y=layers.fill_constant(shape=[1], dtype='float32',
                                   value=float(decay_steps)))
        frac = layers.scale(x=gs, scale=1.0 / float(decay_steps))
    one_minus = layers.scale(x=frac, scale=-1.0, bias=1.0)
    powed = layers.pow(x=one_minus, attrs={'factor': float(power)})
    return layers.scale(x=powed,
                        scale=float(learning_rate - end_learning_rate),
                        bias=float(end_learning_rate))


def piecewise_decay(boundaries, values):
    """values[i] for a step in [boundaries[i-1], boundaries[i]): nested
    ``select`` ops on ``less_than``, from the last interval back."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    global_step = _decay_step_counter()
    lr = layers.fill_constant(shape=[1], dtype='float32', value=values[-1])
    for b, v in reversed(list(zip(boundaries, values[:-1]))):
        bconst = layers.fill_constant(shape=[1], dtype='float32',
                                      value=float(b))
        cond = layers.less_than(x=global_step, y=bconst)
        vconst = layers.fill_constant(shape=[1], dtype='float32',
                                      value=float(v))
        lr = layers.select(cond, vconst, lr)
    return lr
