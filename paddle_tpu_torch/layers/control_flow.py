"""Control-flow layers.

Reference parity: paddle_tpu/layers/control_flow.py (fluid
layers/control_flow.py: While, StaticRNN, DynamicRNN, IfElse,
ConditionalBlock, the array and rank-table layers).  Semantics as the
reference's (ops/control_flow.py): While runs a bounded masked loop (a
``max_iters`` bound, explicit or inferred from a ``less_than(counter,
fill_constant)`` condition); StaticRNN and DynamicRNN loop over the time
axis; IfElse computes both branches on the whole batch and merges rows by
the condition (``select``).  ``ParallelDo`` comes with distribution
(ROADMAP.md Queue 1 item 10).
"""
import contextlib

from ..core.program import LEN_SUFFIX, Variable
from .layer_helper import LayerHelper

__all__ = [
    'While', 'StaticRNN', 'DynamicRNN', 'IfElse', 'ConditionalBlock',
    'lod_rank_table', 'max_sequence_len', 'lod_tensor_to_array',
    'array_to_lod_tensor', 'increment', 'array_write', 'create_array',
    'array_read', 'array_length', 'shrink_memory', 'less_than', 'equal',
    'Print', 'ParallelDo', 'split_lod_tensor', 'merge_lod_tensor',
    'BlockGuard', 'WhileGuard', 'BlockGuardWithCompletion',
    'StaticRNNMemoryLink', 'reorder_lod_tensor_by_rank',
]

from .tensor import less_than, equal  # noqa: E402  (fluid puts them here)


def increment(x, value=1.0, in_place=True, **kwargs):
    helper = LayerHelper('increment', **kwargs)
    out = x if in_place else helper.create_tmp_variable(x.dtype)
    helper.append_op(type='increment', inputs={'X': [x]},
                     outputs={'Out': [out]}, attrs={'step': float(value)},
                     infer_shape=False)
    return out


def create_array(dtype='float32', **kwargs):
    helper = LayerHelper('create_array', **kwargs)
    arr = helper.create_variable(
        name=helper.name + '.out', dtype=dtype, shape=(), lod_level=0)
    helper.append_op(type='create_array', inputs={},
                     outputs={'Out': [arr]},
                     attrs={'elem_dtype': dtype}, infer_shape=False)
    return arr


def array_write(x, i, array=None, capacity=None, **kwargs):
    """`capacity` bounds the buffer allocated by a first write (e.g. a
    beam-search decode loop's max_len); default DEFAULT_CAPACITY."""
    helper = LayerHelper('array_write', **kwargs)
    if array is None:
        array = create_array(dtype=x.dtype)
    attrs = {} if capacity is None else {'capacity': int(capacity)}
    helper.append_op(
        type='write_to_array',
        inputs={'Array': [array], 'V': [x], 'I': [i]},
        outputs={'Out': [array]}, attrs=attrs, infer_shape=False)
    return array


def array_read(array, i, **kwargs):
    helper = LayerHelper('array_read', **kwargs)
    out = helper.create_tmp_variable('float32')
    helper.append_op(
        type='read_from_array', inputs={'Array': [array], 'I': [i]},
        outputs={'Out': [out]}, infer_shape=False)
    return out


def array_length(array, **kwargs):
    helper = LayerHelper('array_length', **kwargs)
    out = helper.create_tmp_variable('int32')
    helper.append_op(type='array_length', inputs={'X': [array]},
                     outputs={'Out': [out]}, infer_shape=False)
    return out


def lod_rank_table(x, level=0, **kwargs):
    """The lengths vector, which stands for the rank table: no sequence
    is reordered, masks replace the batch shrinking."""
    helper = LayerHelper('lod_rank_table', **kwargs)
    out = helper.create_tmp_variable('int32')
    inputs = {'X': [x]}
    block = helper.main_program.current_block()
    if block.has_var_recursive(x.name + LEN_SUFFIX):
        inputs['XLen'] = [block.var_recursive(x.name + LEN_SUFFIX)]
    helper.append_op(type='lod_rank_table', inputs=inputs,
                     outputs={'Out': [out]}, infer_shape=False)
    return out


def max_sequence_len(rank_table, **kwargs):
    helper = LayerHelper('max_seqence_len', **kwargs)
    out = helper.create_tmp_variable('int32')
    helper.append_op(type='max_sequence_len',
                     inputs={'RankTable': [rank_table]},
                     outputs={'Out': [out]}, infer_shape=False)
    return out


def lod_tensor_to_array(x, table=None, **kwargs):
    helper = LayerHelper('lod_tensor_to_array', **kwargs)
    arr = helper.create_variable(name=helper.name + '.out', dtype=x.dtype,
                                 shape=(), lod_level=0)
    helper.append_op(type='lod_tensor_to_array', inputs={'X': [x]},
                     outputs={'Out': [arr]}, infer_shape=False)
    return arr


def array_to_lod_tensor(x, table=None, **kwargs):
    helper = LayerHelper('array_to_lod_tensor', **kwargs)
    out = helper.create_tmp_variable('float32', lod_level=1)
    helper.append_op(type='array_to_lod_tensor', inputs={'X': [x]},
                     outputs={'Out': [out]}, infer_shape=False)
    return out


def shrink_memory(x, i, table, **kwargs):
    helper = LayerHelper('shrink_memory', **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type='shrink_rnn_memory',
        inputs={'X': [x], 'I': [i], 'RankTable': [table]},
        outputs={'Out': [out]}, infer_shape=False)
    return out


def split_lod_tensor(input, mask, level=0, **kwargs):
    """Fluid splits rows by mask into two tensors.  Dense equivalent:
    both "halves" keep full shape; rows not in the half are zeroed.  Used
    by IfElse; the merge is mask-select, so the round trip is exact."""
    helper = LayerHelper('split_lod_tensor', **kwargs)
    out_true = helper.create_tmp_variable(input.dtype)
    out_false = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type='split_lod_tensor',
        inputs={'X': [input], 'Mask': [mask]},
        outputs={'OutTrue': [out_true], 'OutFalse': [out_false]},
        infer_shape=False)
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0, **kwargs):
    helper = LayerHelper('merge_lod_tensor', **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type='merge_lod_tensor',
        inputs={'X': [x], 'Mask': [mask], 'InTrue': [in_true],
                'InFalse': [in_false]},
        outputs={'Out': [out]}, infer_shape=False)
    return out


def Print(input, first_n=-1, message=None, summarize=-1,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase='both', **kwargs):
    """fluid.layers.Print: the ``print`` op prints the message and the
    value when it runs, and passes the value on."""
    helper = LayerHelper('print', **kwargs)
    helper.append_op(
        type='print', inputs={'In': [input]}, outputs={'Out': [input]},
        attrs={'message': message or '', 'first_n': first_n,
               'summarize': summarize}, infer_shape=False)
    return input


class BlockGuard(object):
    def __init__(self, main_program):
        self.main_program = main_program

    def __enter__(self):
        self.main_program.create_block()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.main_program.rollback()
        return exc_type is None


class WhileGuard(BlockGuard):
    def __init__(self, while_op):
        super(WhileGuard, self).__init__(while_op.helper.main_program)
        self.while_op = while_op

    def __enter__(self):
        self.while_op.status = While.IN_WHILE_BLOCK
        ret = super(WhileGuard, self).__enter__()
        self.while_op.sub_block_idx = \
            self.main_program.current_block().idx
        return ret

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            # still roll back so the program isn't left inside the
            # abandoned sub-block
            self.main_program.rollback()
            return False
        self.while_op.status = While.AFTER_WHILE_BLOCK
        # roll back to the parent block FIRST so the `while` op itself
        # lands in the parent, then emit it
        ret = super(WhileGuard, self).__exit__(exc_type, exc_val, exc_tb)
        self.while_op.complete()
        return ret


class While(object):
    """fluid.layers.While parity.  `max_iters` bounds the masked scan; if
    omitted, it is inferred from a `less_than(counter, fill_constant)`
    condition."""

    BEFORE_WHILE_BLOCK = 0
    IN_WHILE_BLOCK = 1
    AFTER_WHILE_BLOCK = 2

    def __init__(self, cond, max_iters=None, name=None):
        self.helper = LayerHelper("while", name=name)
        self.status = While.BEFORE_WHILE_BLOCK
        if not isinstance(cond, Variable):
            raise TypeError("condition should be a variable")
        self.cond_var = cond
        self.max_iters = max_iters

    def block(self):
        return WhileGuard(self)

    def _infer_max_iters(self):
        """Find `less_than(X=counter, Y=limit)` producing the condition,
        with `limit` from a fill_constant — the loop bound."""
        block = self.helper.main_program.blocks[0]
        limit_name = None
        for op in block.ops:
            if op.type == 'less_than' and \
                    self.cond_var.name in op.output_arg_names:
                limit_name = op.inputs.get('Y', [None])[0]
        if limit_name is None:
            return None
        for op in block.ops:
            if op.type == 'fill_constant' and \
                    limit_name in op.output_arg_names:
                return int(op.attrs['value'])
        return None

    def complete(self):
        max_iters = self.max_iters
        if max_iters is None:
            max_iters = self._infer_max_iters()
        self.helper.append_op(
            type='while',
            inputs={'Condition': [self.cond_var]},
            outputs={},
            attrs={'sub_block': self.sub_block_idx,
                   'condition': self.cond_var.name,
                   'max_iters': max_iters},
            infer_shape=False)


class StaticRNN(object):
    """fluid.layers.StaticRNN: a per-timestep block that the ``recurrent``
    op runs once a step (step_input, memory, update_memory, step_output,
    output)."""

    BEFORE_RNN_BLOCK = 0
    IN_RNN_BLOCK = 1
    AFTER_RNN_BLOCK = 2

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self.memories = {}  # inner mem var name -> (boot var, updated name)
        self.step_inputs = []  # (outer var, inner var)
        self.step_outputs = []  # inner vars
        self.status = StaticRNN.BEFORE_RNN_BLOCK
        self.seq_len = None
        self._block_idx = None
        self._lengths_var = None

    @contextlib.contextmanager
    def step(self):
        self.status = StaticRNN.IN_RNN_BLOCK
        prog = self.helper.main_program
        prog.create_block()
        self._block_idx = prog.current_block().idx
        yield
        self.status = StaticRNN.AFTER_RNN_BLOCK
        prog.rollback()
        self._complete_op()

    def _assert_in_rnn_block_(self, method):
        if self.status != StaticRNN.IN_RNN_BLOCK:
            raise ValueError("You must invoke {0} in rnn block".format(
                method))

    def step_input(self, x):
        """x: [B, T, ...] outer var -> per-step [B, ...] inner var."""
        self._assert_in_rnn_block_('step_input')
        block = self.helper.main_program.current_block()
        inner = block.create_var(
            name=x.name + '@step', dtype=x.dtype,
            shape=(x.shape[0],) + tuple(x.shape[2:]), lod_level=0)
        self.step_inputs.append((x, inner))
        if self.seq_len is None:
            self.seq_len = x.shape[1]
        outer_block = self.helper.main_program.blocks[0]
        if x.lod_level > 0 and \
                outer_block.has_var_recursive(x.name + LEN_SUFFIX):
            self._lengths_var = outer_block.var_recursive(
                x.name + LEN_SUFFIX)
        return inner

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1,
               dtype='float32'):
        self._assert_in_rnn_block_('memory')
        if init is None:
            if shape is None and batch_ref is None:
                raise ValueError("memory needs init or shape/batch_ref")
            helper = self.helper
            # boot memory [batch, *shape] built with
            # fill_constant_batch_size_like in the OUTER block
            from .tensor import fill_constant_batch_size_like
            prog = helper.main_program
            cur = prog.current_block_idx
            prog.current_block_idx = 0
            ref = batch_ref if batch_ref is not None else \
                self.step_inputs[0][0]
            init = fill_constant_batch_size_like(
                input=ref, shape=[-1] + list(shape[1:] if shape else []),
                value=init_value, dtype=dtype,
                input_dim_idx=init_batch_dim_idx)
            prog.current_block_idx = cur
        block = self.helper.main_program.current_block()
        mem = block.create_var(
            name=init.name + '@mem', dtype=init.dtype,
            shape=init.shape, lod_level=0)
        self.memories[mem.name] = [init, None, mem]
        return mem

    def update_memory(self, mem, x):
        self._assert_in_rnn_block_('update_memory')
        self.memories[mem.name][1] = x.name

    def step_output(self, o):
        self._assert_in_rnn_block_('step_output')
        self.step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _complete_op(self):
        helper = self.helper
        block = helper.main_program.blocks[0]
        inputs = {'__ignore__': []}
        memories_attr = []
        for mem_name, (boot, upd_name, mem) in self.memories.items():
            if upd_name is None:
                raise ValueError("memory %s never updated" % mem_name)
            inputs['Boot_' + mem_name] = [boot]
            memories_attr.append((mem_name, upd_name))
        if self._lengths_var is not None:
            inputs['XLen'] = [self._lengths_var]
        self._outer_outputs = []
        outputs = {}
        for o in self.step_outputs:
            outer = block.create_var(
                name=o.name + '@stacked', dtype=o.dtype,
                shape=(o.shape[0], self.seq_len) + tuple(o.shape[1:]),
                lod_level=1 if self._lengths_var is not None else 0)
            outputs['Out_' + o.name] = [outer]
            self._outer_outputs.append(outer)
            if self._lengths_var is not None:
                ln = block.create_var(
                    name=outer.name + LEN_SUFFIX, shape=[-1],
                    dtype='int32')
                ln.stop_gradient = True
                helper.append_op(
                    type='assign', inputs={'X': [self._lengths_var]},
                    outputs={'Out': [ln]}, infer_shape=False)
        helper.append_op(
            type='recurrent',
            inputs=inputs,
            outputs=outputs,
            attrs={'sub_block': self._block_idx,
                   'step_inputs': [(o.name, i.name)
                                   for o, i in self.step_inputs],
                   'memories': memories_attr,
                   'step_outputs': [o.name for o in self.step_outputs],
                   'seq_len': self.seq_len},
            infer_shape=False)

    def __call__(self, *args, **kwargs):
        outs = self._outer_outputs
        return outs[0] if len(outs) == 1 else outs


class DynamicRNN(object):
    """fluid.layers.DynamicRNN over padded + lengths sequences: StaticRNN's
    loop with per-row masks (a padded step carries the memory through and
    emits zeros), the dense equivalent of fluid's rank-table sort and
    per-step batch shrinking."""

    BEFORE_RNN = 0
    IN_RNN = 1
    AFTER_RNN = 2

    def __init__(self, name=None):
        self._rnn = StaticRNN(name=name)
        self.status = DynamicRNN.BEFORE_RNN

    @contextlib.contextmanager
    def block(self):
        self.status = DynamicRNN.IN_RNN
        with self._rnn.step():
            yield
        self.status = DynamicRNN.AFTER_RNN

    def step_input(self, x):
        return self._rnn.step_input(x)

    def static_input(self, x):
        return x  # dense batch: static inputs are just closed over

    def memory(self, init=None, shape=None, value=0.0, dtype='float32',
               **kw):
        return self._rnn.memory(init=init, shape=[-1] + list(shape or []),
                                init_value=value, dtype=dtype)

    def update_memory(self, ex_mem, new_mem):
        self._rnn.update_memory(ex_mem, new_mem)

    def output(self, *outputs):
        self._rnn.output(*outputs)

    def __call__(self, *args, **kwargs):
        if self.status != DynamicRNN.AFTER_RNN:
            raise ValueError(
                "Output of the dynamic RNN can only be visited "
                "outside the rnn block.")
        return self._rnn()


class IfElse(object):
    """fluid.layers.IfElse parity.  Dense semantics: both branches run on
    the FULL batch; `input(x)` hands the branch the full tensor, and the
    final outputs merge rows by the boolean condition — exactly fluid's
    split_lod_tensor/merge_lod_tensor composition, without gathers."""

    OUT_IF_ELSE_BLOCKS = 0
    IN_IF_ELSE_TRUE_BLOCKS = 1
    IN_IF_ELSE_FALSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper('ifelse', name=name)
        self.cond = cond
        self.status = IfElse.OUT_IF_ELSE_BLOCKS
        self.output_table = [[], []]  # false, true

    @contextlib.contextmanager
    def true_block(self):
        self.status = IfElse.IN_IF_ELSE_TRUE_BLOCKS
        yield
        self.status = IfElse.OUT_IF_ELSE_BLOCKS

    @contextlib.contextmanager
    def false_block(self):
        self.status = IfElse.IN_IF_ELSE_FALSE_BLOCKS
        yield
        self.status = IfElse.OUT_IF_ELSE_BLOCKS

    def input(self, x):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("input() must be called inside a branch block")
        return x

    def output(self, *outs):
        if self.status == IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("output() must be called inside a branch")
        table = self.output_table[
            1 if self.status == IfElse.IN_IF_ELSE_TRUE_BLOCKS else 0]
        table.extend(outs)

    def __call__(self):
        if self.status != IfElse.OUT_IF_ELSE_BLOCKS:
            raise ValueError("IfElse::__call__ must be out of sub-block")
        false_outs, true_outs = self.output_table
        if len(false_outs) != len(true_outs):
            raise ValueError("true and false blocks must produce the same "
                             "number of outputs")
        rets = []
        from .tensor import select
        for t, f in zip(true_outs, false_outs):
            rets.append(select(self.cond, t, f))
        return rets[0] if len(rets) == 1 else rets


class ConditionalBlock(object):
    """fluid.layers.ConditionalBlock: the ops built inside ``block()`` run,
    and each variable they write takes their value where the scalar
    condition holds, else its old one (operators/conditional_block_op.cc's
    scope semantics, by a select)."""

    def __init__(self, inputs, name=None):
        # parity signature: inputs = [cond_var]; the reference also allows
        # extra block-input vars with elementwise (non-scalar) conditions,
        # which this build does not implement — fail loudly, not silently
        if not inputs:
            raise ValueError("ConditionalBlock needs the condition var")
        if len(inputs) > 1:
            raise NotImplementedError(
                "only the scalar-condition form ConditionalBlock([cond]) "
                "is supported; use IfElse for per-row conditions")
        self.cond = inputs[0]
        self.helper = LayerHelper('conditional_block', name=name)

    @contextlib.contextmanager
    def block(self):
        prog = self.helper.main_program
        sub_block = prog.create_block()
        try:
            yield
        except Exception:
            prog.rollback()  # leave the program usable (as WhileGuard)
            raise
        prog.rollback()
        # declare the sub-block's written vars (nested control-flow blocks
        # included — same recursion the runtime uses) as op outputs:
        # autodiff publishing, prune reachability, and fetch all key off
        # output_arg_names (the op publishes values via __env_update__)
        from ..ops.control_flow import _block_rw
        _, written_names = _block_rw(prog, sub_block.idx)
        written = []
        for n in sorted(written_names):
            try:
                written.append(sub_block.var_recursive(n))
            except KeyError:
                pass
        self.helper.append_op(
            type='conditional_block',
            inputs={'Cond': [self.cond]},
            outputs={'Out': written},
            attrs={'sub_block': sub_block.idx},
            infer_shape=False)


class ParallelDo(object):
    """fluid.layers.ParallelDo: splits the batch across places and runs its
    block on each.  It comes with distribution (ROADMAP.md Queue 1 item
    10); building one raises."""

    def __init__(self, places=None, use_nccl=False, name=None):
        raise NotImplementedError(
            "layers.ParallelDo (the parallel_do op) is not ported yet: "
            "ROADMAP.md Queue 1, item 10 (distribution)")


def reorder_lod_tensor_by_rank(x, rank_table, **kwargs):
    """Reorder batch rows by the rank table's descending-length order
    (ref fluid/layers/control_flow.py:reorder_lod_tensor_by_rank over
    operators/reorder_lod_tensor_by_rank_op.cc).  The reordered lengths
    ride along as the output's @LEN companion so downstream ragged ops
    keep masking correctly."""
    helper = LayerHelper('reorder_lod_tensor_by_rank', **kwargs)
    block = helper.main_program.current_block()
    out = helper.create_tmp_variable(x.dtype, lod_level=x.lod_level)
    out_len = block.create_var(name=out.name + LEN_SUFFIX, shape=[-1],
                               dtype='int32')
    out_len.stop_gradient = True
    order = helper.create_tmp_variable('int32')
    helper.append_op(
        type='reorder_lod_tensor_by_rank',
        inputs={'X': [x], 'RankTable': [rank_table]},
        outputs={'Out': [out], 'OutLen': [out_len],
                 'OrderedIndex': [order]})
    return out


class BlockGuardWithCompletion(BlockGuard):
    """Parity alias (ref fluid/layers/control_flow.py): a BlockGuard
    that completes its op on exit — StaticRNN and While do the
    completion in their own __exit__, so this is the plain guard."""

    def __init__(self, rnn):
        super(BlockGuardWithCompletion, self).__init__(
            rnn.helper.main_program)
        self.rnn = rnn


class StaticRNNMemoryLink(object):
    """Parity record (ref fluid/layers/control_flow.py): links an
    init-state var to its per-step memory var inside StaticRNN."""

    def __init__(self, init, pre_mem, mem=None):
        self.init = init
        self.pre_mem = pre_mem
        self.mem = mem
