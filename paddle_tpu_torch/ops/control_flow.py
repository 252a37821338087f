"""Control-flow ops: while, conditional_block, recurrent.

Reference parity: paddle_tpu/ops/control_flow.py (paddle/operators/
while_op.cc, conditional_block_op.cc, recurrent_op.cc).  Each op
interprets its sub-block eagerly (``ExecutionContext.run_block``) with the
reference's semantics, and gradients flow through all three by autograd:

- ``while``: a loop of exactly ``max_iters`` ticks.  Each tick runs the
  body on a copy of the environment and keeps the old carry where the
  condition has gone false (``torch.where`` on a device bool: the
  condition is never read on the host).  The carry is the names the body
  writes that exist before the loop, and the condition.  An array first
  written inside the loop comes out of a loop that never ran as a zeroed
  buffer of size 0, as the reference's probe makes it.
- ``conditional_block``: the block runs, and each name it writes takes
  the block's value where the scalar condition holds, else its old value
  (zero for a name born inside the block).
- ``recurrent`` (StaticRNN, DynamicRNN): a loop over the time axis with
  the memories carried; with ``XLen`` a row past its length keeps its
  memory and emits zeros.

``parallel_do`` is not registered: it comes with distribution (ROADMAP.md
Queue 1 item 10).
"""
import torch

from ..core.registry import register_op
from ..transpiler.passes import _block_rw_recursive as _block_rw
from .common import first
from .tensor_array import EmptyTArray, TArray

__all__ = []


def _scalar_bool(x):
    return x.reshape(()).bool()


def _select(pred, new, old):
    if isinstance(new, TArray):
        return TArray(torch.where(pred, new.data, old.data),
                      torch.where(pred, new.size, old.size))
    return torch.where(pred, new, old)


def _zeros_like(v):
    if isinstance(v, TArray):
        return TArray(torch.zeros_like(v.data), torch.zeros_like(v.size))
    return torch.zeros_like(v)


@register_op('while', needs_env=True)
def _while(ctx, ins, attrs):
    sub_idx = int(attrs['sub_block'])
    cond_name = attrs['condition']
    max_iters = attrs.get('max_iters')
    if max_iters is None:
        raise ValueError(
            "while op needs max_iters (pass max_iters= to layers.While, or "
            "use a less_than(counter, fill_constant) condition so the bound "
            "is inferable)")
    max_iters = int(max_iters)

    read, written = _block_rw(ctx.program, sub_idx)
    env = ins['__env__'][0]
    carry_names = sorted(n for n in written if n in env)
    if cond_name not in carry_names and cond_name in env:
        carry_names.append(cond_name)
    carry = {n: env[n] for n in carry_names}
    # arrays first written inside the loop: the first tick allocates
    # them, and a tick whose condition is false keeps the zeroed buffer
    empty = [n for n, v in carry.items() if isinstance(v, EmptyTArray)]
    if empty and max_iters == 0:
        probe = dict(env)
        ctx.run_block(sub_idx, probe)
        carry.update({n: _zeros_like(_probed(probe, n)) for n in empty})
    for _ in range(max_iters):
        active = _scalar_bool(carry[cond_name])
        env2 = dict(env)
        env2.update(carry)
        ctx.run_block(sub_idx, env2)
        new = {n: env2[n] for n in carry_names}
        for n in empty:
            carry[n] = _zeros_like(_probed(env2, n))
        empty = []
        carry = {n: _select(active, new[n], carry[n]) for n in carry_names}
    return {'__env_update__': [carry]}


def _probed(env, name):
    v = env.get(name)
    if not isinstance(v, TArray):
        raise ValueError(
            "tensor array %r is read in a while loop before any write; "
            "write once before the loop or pass elem_shape to "
            "create_array" % name)
    return v


@register_op('conditional_block', needs_env=True)
def _conditional_block(ctx, ins, attrs):
    sub_idx = int(attrs['sub_block'])
    cond = _scalar_bool(first(ins, 'Cond'))
    env = ins['__env__'][0]
    read, written = _block_rw(ctx.program, sub_idx)
    env2 = dict(env)
    ctx.run_block(sub_idx, env2)
    update = {}
    for n in written:
        if n in env2:
            old = env[n] if n in env else _zeros_like(env2[n])
            update[n] = _select(cond, env2[n], old)
    return {'__env_update__': [update]}


@register_op('recurrent', needs_env=True)
def _recurrent(ctx, ins, attrs):
    """StaticRNN / DynamicRNN: a loop over the time axis.

    attrs: sub_block, step_inputs [(outer_name, inner_name)], memories
    [(inner_mem_name, inner_updated_name)], step_outputs [inner_name],
    seq_len; inputs 'Boot_<mem>' and, optionally, the lengths 'XLen'.
    Outputs 'Out_<name>' [B, T, ...] and 'FinalMem_<mem>'."""
    sub_idx = int(attrs['sub_block'])
    step_inputs = [tuple(p) for p in attrs['step_inputs']]
    memories = [tuple(p) for p in attrs['memories']]
    step_outputs = list(attrs['step_outputs'])
    env = ins['__env__'][0]

    xs = {inner: env[outer].movedim(1, 0)
          for outer, inner in step_inputs}   # [T, B, ...]
    T = next(iter(xs.values())).shape[0] if xs else int(attrs['seq_len'])
    mems = {mem: ins['Boot_' + mem][0] for mem, _ in memories}
    lengths = first(ins, 'XLen')
    outs = [[] for _ in step_outputs]
    for t in range(T):
        env2 = dict(env)
        env2.update({inner: x[t] for inner, x in xs.items()})
        env2.update(mems)
        ctx.run_block(sub_idx, env2)
        active = None if lengths is None else lengths.to(torch.int32) > t
        new_mems = {}
        for mem, upd in memories:
            new = env2[upd]
            if active is not None:
                new = torch.where(_rows(active, new), new, mems[mem])
            new_mems[mem] = new
        mems = new_mems
        for o_t, n in zip(outs, step_outputs):
            o = env2[n]
            if active is not None:
                o = torch.where(_rows(active, o), o, torch.zeros_like(o))
            o_t.append(o)
    result = {'Out_' + n: [torch.stack(o, dim=1)]
              for n, o in zip(step_outputs, outs)}   # [B, T, ...]
    for mem, _ in memories:
        result['FinalMem_' + mem] = [mems[mem]]
    return result


def _rows(active, x):
    return active.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
