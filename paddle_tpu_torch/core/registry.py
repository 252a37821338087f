"""Op registry.

Reference parity: paddle_tpu/core/registry.py (paddle/framework/
op_registry.h), the registration half.  Each op type maps to one compute
function

    def compute(ctx, ins, attrs) -> {slot: [torch.Tensor, ...]}

where ``ins`` is {slot: [tensors]} and ``ctx`` is the executor's
ExecutionContext (device, per-op random generator).  The function runs
eagerly on the tensors' device; a kernel is reached through its wrapper,
which dispatches on that device.
"""

__all__ = ['OpImpl', 'register_op', 'get_op_impl', 'has_op']

_OP_REGISTRY = {}


class OpImpl(object):
    def __init__(self, type, compute, stateful_rng=False):
        self.type = type
        self.compute = compute
        # ops that draw random numbers (uniform_random): the executor
        # hands them a generator keyed by the op's position
        self.stateful_rng = stateful_rng


def register_op(type, stateful_rng=False):
    def deco(fn):
        if type in _OP_REGISTRY:
            raise ValueError("op %r already registered" % type)
        _OP_REGISTRY[type] = OpImpl(type, fn, stateful_rng)
        return fn

    return deco


def get_op_impl(type):
    impl = _OP_REGISTRY.get(type)
    if impl is None:
        raise NotImplementedError(
            "op %r has no implementation in paddle_tpu_torch yet; the port "
            "brings ops slice by slice (ROADMAP.md, Queue 1)" % type)
    return impl


def has_op(type):
    return type in _OP_REGISTRY

