"""Define-then-run program IR.

Reference parity: paddle_tpu/core/program.py (paddle/framework/
{program_desc,block_desc,op_desc,var_desc}, fluid framework.py).  Users
build a Program of Blocks of Operators over symbolic Variables; the
Executor (core/executor.py) runs a block op by op on the card.

``Program.to_dict`` / ``Program.from_dict`` keep the reference's format,
so a program the reference built and serialised loads here unchanged.
"""
import collections
import contextlib
import copy
import itertools
import json

import numpy as np

from . import datatypes

__all__ = [
    'Variable', 'Parameter', 'Operator', 'Block', 'Program',
    'default_main_program', 'default_startup_program', 'program_guard',
    'switch_main_program', 'switch_startup_program', 'unique_name',
    'grad_var_name', 'name_scope', 'reset_unique_name_guard', 'LEN_SUFFIX',
]

GRAD_SUFFIX = '@GRAD'
# companion int32 [batch] sequence-length vector of a ragged (lod_level > 0)
# variable: ``x`` is padded [batch, time, ...], ``x@LEN`` its lengths
LEN_SUFFIX = '@LEN'


def grad_var_name(name):
    return name + GRAD_SUFFIX


class _UniqueNameGenerator(object):
    def __init__(self):
        self.ids = collections.defaultdict(int)

    def __call__(self, key):
        self.ids[key] += 1
        return "%s_%d" % (key, self.ids[key] - 1)


_name_generator = _UniqueNameGenerator()
_name_scope_stack = []


def unique_name(key):
    prefix = "/".join(_name_scope_stack)
    name = _name_generator(key)
    return prefix + "/" + name if prefix else name


@contextlib.contextmanager
def name_scope(prefix):
    _name_scope_stack.append(prefix)
    try:
        yield
    finally:
        _name_scope_stack.pop()


@contextlib.contextmanager
def reset_unique_name_guard():
    """A fresh name counter inside the guard (reproducible program
    text)."""
    global _name_generator
    old = _name_generator
    _name_generator = _UniqueNameGenerator()
    try:
        yield
    finally:
        _name_generator = old


class Variable(object):
    """Symbolic tensor in a Block.

    Shape may contain -1 (unknown / batch dimension).  ``persistable``
    variables live in the Scope across Executor.run calls (parameters,
    optimizer state).
    """

    def __init__(self,
                 block,
                 name=None,
                 shape=None,
                 dtype='float32',
                 lod_level=0,
                 persistable=False,
                 stop_gradient=False,
                 is_data=False,
                 initializer=None):
        self.block = block
        self.name = name if name is not None else unique_name('_generated_var')
        self.shape = tuple(int(d) for d in shape) if shape is not None else ()
        self.dtype = datatypes.convert_dtype(dtype)
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.initializer = initializer
        block._add_var(self)

    @property
    def program(self):
        return self.block.program

    @property
    def persistable(self):
        return self._persistable

    @persistable.setter
    def persistable(self, value):
        # the executor's plans keep what outlives a step by this flag
        self._persistable = value
        self.block.program._bump_version()

    def astype(self, dtype):
        from .. import layers
        return layers.cast(x=self, dtype=dtype)

    def __repr__(self):
        return "Variable(name=%s, shape=%s, dtype=%s, lod_level=%d%s)" % (
            self.name, self.shape, self.dtype, self.lod_level,
            ", persistable" if self.persistable else "")

    __str__ = __repr__

    def to_dict(self):
        return dict(name=self.name, shape=list(self.shape), dtype=self.dtype,
                    lod_level=self.lod_level, persistable=self.persistable,
                    stop_gradient=self.stop_gradient, is_data=self.is_data,
                    trainable=getattr(self, 'trainable', False),
                    is_parameter=isinstance(self, Parameter))


class Parameter(Variable):
    """A trainable persistable Variable."""

    def __init__(self, block, shape, dtype, **kwargs):
        self.trainable = kwargs.pop('trainable', True)
        self.optimize_attr = kwargs.pop('optimize_attr',
                                        {'learning_rate': 1.0})
        self.regularizer = kwargs.pop('regularizer', None)
        self.gradient_clip_attr = kwargs.pop('gradient_clip_attr', None)
        self.error_clip = kwargs.pop('error_clip', None)
        if any(d <= 0 for d in shape):
            raise ValueError("parameter shape must be fully static, got %s" %
                             (shape,))
        super(Parameter, self).__init__(
            block, shape=shape, dtype=dtype, persistable=True, **kwargs)


class Operator(object):
    """One op in a block: type + named input/output slots (lists of var
    names) + attrs.  Attrs must be JSON-serialisable."""

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.inputs = {
            k: [v.name if isinstance(v, Variable) else v for v in _as_list(vs)]
            for k, vs in (inputs or {}).items()
        }
        self.outputs = {
            k: [v.name if isinstance(v, Variable) else v for v in _as_list(vs)]
            for k, vs in (outputs or {}).items()
        }
        self.attrs = dict(attrs or {})

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def has_attr(self, name):
        return name in self.attrs

    def attr(self, name):
        return self.attrs[name]

    def set_attr(self, name, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    def __repr__(self):
        return "{%s: (%s) -> (%s)}" % (self.type, dict(self.inputs),
                                       dict(self.outputs))

    def to_dict(self):
        return dict(type=self.type, inputs=self.inputs, outputs=self.outputs,
                    attrs=_jsonable_attrs(self.attrs))


def _as_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _jsonable_attrs(attrs):
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = {'__ndarray__': v.tolist(), 'dtype': str(v.dtype)}
        elif isinstance(v, (np.integer,)):
            out[k] = int(v)
        elif isinstance(v, (np.floating,)):
            out[k] = float(v)
        else:
            out[k] = v
    return out


class Block(object):
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()
        self.ops = []

    @property
    def parent(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def _add_var(self, var):
        self.vars[var.name] = var
        self.program._bump_version()

    def create_var(self, **kwargs):
        return Variable(self, **kwargs)

    def create_parameter(self, **kwargs):
        return Parameter(self, **kwargs)

    def has_var(self, name):
        return name in self.vars

    def has_var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return True
            b = b.parent
        return False

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise KeyError("variable %r not in block %d" % (name, self.idx))
        return v

    def var_recursive(self, name):
        b = self
        while b is not None:
            if name in b.vars:
                return b.vars[name]
            b = b.parent
        raise KeyError("variable %r not found up the block chain" % name)

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  index=None):
        attrs = dict(attrs or {})
        # the current role (forward/backward/optimize) tells the executor
        # model ops from grad and update machinery (fluid's OpRole attr)
        attrs.setdefault('op_role', self.program._current_role)
        op = Operator(self, type, inputs, outputs, attrs)
        if index is None:
            self.ops.append(op)
        else:
            self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def __repr__(self):
        lines = ["block[%d] parent=%d" % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append("  " + repr(v))
        for op in self.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)


class Program(object):
    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._current_role = 'forward'
        # process-unique identity, never reused after garbage collection
        self._uid = next(Program._uid_counter)
        # bumped by every var or op added, every set_attr and every change
        # of a var's persistable flag, so a plan worked out from an older
        # program is never reused
        self._version = 0

    @contextlib.contextmanager
    def op_role_guard(self, role):
        """Ops appended inside the guard are stamped with ``role``
        ('forward' | 'backward' | 'optimize')."""
        old, self._current_role = self._current_role, role
        try:
            yield
        finally:
            self._current_role = old

    def _bump_version(self):
        self._version += 1

    @property
    def version(self):
        return self._version

    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def list_vars(self):
        for b in self.blocks:
            for v in b.vars.values():
                yield v

    def all_parameters(self):
        return [v for v in self.list_vars() if isinstance(v, Parameter)]

    def clone(self, for_test=False):
        """Deep-copy the program; with for_test=True every op's
        ``is_test`` attr is set."""
        p = copy.deepcopy(self)
        p._uid = next(Program._uid_counter)
        if for_test:
            for block in p.blocks:
                for op in block.ops:
                    if 'is_test' in op.attrs:
                        op.attrs['is_test'] = True
        return p

    def prune(self, targets, feeds=()):
        """A copy keeping only the ops that compute ``targets`` (names or
        Variables) from ``feeds``, which count as produced (reference:
        paddle_tpu/core/program.py ``prune``, paddle/framework/prune.cc):
        backward reachability over the def-use graph."""
        target_names = set(t.name if isinstance(t, Variable) else t
                           for t in _as_list(targets))
        feed_names = set(f.name if isinstance(f, Variable) else f
                         for f in _as_list(feeds))
        p = copy.deepcopy(self)
        p._uid = next(Program._uid_counter)
        for block in p.blocks:
            needed = set(target_names)
            kept = []
            for op in reversed(block.ops):
                out_names = set(op.output_arg_names)
                if out_names & needed:
                    kept.append(op)
                    needed -= out_names
                    for n in op.input_arg_names:
                        if n not in feed_names:
                            needed.add(n)
                    # a sub-block op depends on everything its block reads
                    for attr in ('sub_block', 'sub_block_idx'):
                        if attr in op.attrs:
                            for sop in p.blocks[op.attrs[attr]].ops:
                                needed.update(sop.input_arg_names)
            kept.reverse()
            block.ops = kept
        p._bump_version()
        return p

    def inference_optimize(self):
        """The inference form of the program: ``clone(for_test=True)``."""
        return self.clone(for_test=True)

    def to_dict(self):
        return dict(
            random_seed=self.random_seed,
            blocks=[
                dict(idx=b.idx, parent_idx=b.parent_idx,
                     vars=[v.to_dict() for v in b.vars.values()],
                     ops=[op.to_dict() for op in b.ops])
                for b in self.blocks
            ])

    def to_json(self):
        return json.dumps(self.to_dict())

    @staticmethod
    def from_dict(d):
        p = Program()
        p.random_seed = d.get('random_seed', 0)
        p.blocks = []
        for bd in d['blocks']:
            b = Block(p, bd['idx'], bd['parent_idx'])
            p.blocks.append(b)
            for vd in bd['vars']:
                vd = dict(vd)
                is_param = vd.pop('is_parameter', False)
                trainable = vd.pop('trainable', False)
                if is_param:
                    vd.pop('persistable', None)
                    Parameter(b, trainable=trainable, **vd)
                else:
                    Variable(b, **vd)
            for od in bd['ops']:
                attrs = {}
                for k, v in od['attrs'].items():
                    if isinstance(v, dict) and '__ndarray__' in v:
                        attrs[k] = np.array(v['__ndarray__'],
                                            dtype=v['dtype'])
                    else:
                        attrs[k] = v
                b.append_op(od['type'], od['inputs'], od['outputs'], attrs)
        p.current_block_idx = 0
        return p

    @staticmethod
    def from_json(s):
        return Program.from_dict(json.loads(s))

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    __str__ = __repr__


_main_program = Program()
_startup_program = Program()


def default_main_program():
    return _main_program


def default_startup_program():
    return _startup_program


def switch_main_program(program):
    global _main_program
    old = _main_program
    _main_program = program
    return old


def switch_startup_program(program):
    global _startup_program
    old = _startup_program
    _startup_program = program
    return old


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    old_main = switch_main_program(main_program)
    old_startup = None
    if startup_program is not None:
        old_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(old_main)
        if old_startup is not None:
            switch_startup_program(old_startup)
