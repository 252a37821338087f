"""Inference deployment: exported-program serving.

Reference parity: paddle_tpu/inference/serving.py, the whole module.
The reference serializes the pruned inference program to a StableHLO
artifact through ``jax.export``; here the same program, through
``Executor.compile``, is traced by ``torch.export`` into an
``ExportedProgram`` that holds the state as buffers, and saved with
``torch.export.save`` (a ``.pt2`` file).  ``torch.export.load`` gives it
back as a module in any process that has ``paddle_tpu_torch`` imported:
the flash-attention forward (#1) is the operator
``paddle_tpu_torch::flash_fwd`` inside the graph, where the reference's
artifact needs only XLA.

- An artifact is specialized on the feed shapes and dtypes it was
  exported at, and on the device: one exported on the card loads on the
  card, one exported on the CPU on the CPU.
- Export on the card raises ``NotImplementedError``, naming the op, for
  a program whose op launches a kernel that is not yet an operator (the
  LSTM and GRU kernels, the optimizer applies; ROADMAP.md Queue 1 item
  8b): tracing cannot follow their ctypes launches, and the kernel
  loader refuses them under tracing (ops/kernels/build.py).
- ``InferenceServer.predict_many`` / ``predict_stacked`` run K requests
  as K launches of the artifact without a host sync between them and
  one at the end; the reference scans them in one program.
"""
import json
import os

import numpy as np
import torch

from ..core import datatypes
from ..core.executor import Executor
from ..core.place import resolve_device
from ..core.program import Variable, default_main_program
from ..core.scope import global_scope
from ..ops.kernels import flash_attention as _fa  # noqa: F401  (the op)

__all__ = ['export_inference', 'load_exported', 'InferenceServer',
           'FeedSpec']

# 64-bit declared dtypes export as their 32-bit counterparts, as the
# executor stages 64-bit feeds (core/executor.py _NARROW)
_NARROW = {'float64': 'float32', 'int64': 'int32'}

_META = 'paddle_tpu_torch.json'


class FeedSpec(tuple):
    """(shape, dtype) of one feed of an artifact: the reference's
    ShapedArray, with a torch dtype."""
    __slots__ = ()

    def __new__(cls, shape, dtype):
        return tuple.__new__(cls, (tuple(shape), dtype))

    shape = property(lambda self: self[0])
    dtype = property(lambda self: self[1])


def _example_args(program, feed_shapes):
    """Zero-valued example feeds at each var's declared dtype (64-bit
    narrowed to 32), as CPU tensors: the artifact specializes on these,
    so a bfloat16 feed var exports a bfloat16 input.  An undeclared name
    is float32."""
    block = program.global_block()
    out = {}
    for name, shape in feed_shapes.items():
        var = block.vars.get(name)
        dt = 'float32' if var is None else datatypes.convert_dtype(var.dtype)
        out[name] = torch.zeros(tuple(shape),
                                dtype=datatypes.as_torch_dtype(
                                    _NARROW.get(dt, dt)))
    return out


class _Servable(torch.nn.Module):
    """The step function of an inference program with its state as
    buffers: ``forward(feed) -> tuple of fetches``.  The new state is
    dropped, as the reference's artifact drops it, so every state tensor
    goes in read-only (no copy of what batch norm writes back as it
    was)."""

    def __init__(self, fn, state, seed):
        super(_Servable, self).__init__()
        self._fn, self._seed = fn, seed
        self._names = list(state)
        for i, t in enumerate(state.values()):
            self.register_buffer('s%d' % i, t)

    def forward(self, feed):
        state = {k: getattr(self, 's%d' % i)
                 for i, k in enumerate(self._names)}
        fetches, _ = self._fn(feed, {}, state, self._seed)
        return tuple(fetches)


def export_inference(path, feed_shapes, target_vars, executor=None,
                     main_program=None, scope=None, device=None):
    """Export the pruned inference computation to a ``torch.export``
    artifact at ``path``.

    :param feed_shapes: {feed_name: concrete shape}; artifacts are
        shape-specialized.
    :param target_vars: output Variables (or names).
    :param device: the executor's place when ``executor`` is None (None:
        the card).
    :returns: the artifact's size in bytes.
    """
    if main_program is None:
        main_program = default_main_program()
    if isinstance(target_vars, (Variable, str)):
        target_vars = [target_vars]
    scope = scope or global_scope()
    exe = executor or Executor(device)
    if executor is not None and device is not None and \
            resolve_device(device) != exe.place:
        raise ValueError("device %s disagrees with the executor's place %s"
                         % (device, exe.place))
    pruned = main_program.prune(targets=target_vars,
                                feeds=list(feed_shapes))
    infer_prog = pruned.inference_optimize()
    feed = _example_args(infer_prog, feed_shapes)
    fn, args = exe.compile(infer_prog, feed=feed, fetch_list=target_vars,
                           scope=scope)
    feed_arrays, state_rw, state_ro, seed = args
    with torch.no_grad():
        exported = torch.export.export(
            _Servable(fn, {**state_rw, **state_ro}, seed), (feed_arrays,),
            strict=False)
    meta = {'device': str(exe.place),
            'fetches': [t.name if isinstance(t, Variable) else str(t)
                        for t in target_vars]}
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    torch.export.save(exported, path,
                      extra_files={_META: json.dumps(meta)})
    return os.path.getsize(path)


def _open_exported(path, device=None):
    """(ExportedProgram, its module, metadata): the one place the load
    sequence lives.  The artifact's device must be ``device``'s type."""
    extra = {_META: ''}
    exported = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META]) if extra[_META] else {}
    want = resolve_device(device)
    have = torch.device(meta.get('device', 'cpu'))
    if have.type != want.type:
        raise ValueError(
            "%s was exported on %s; load it with device=%r (an artifact "
            "is specialized on the device it was exported on)"
            % (path, have, have.type))
    return exported, exported.module(), meta, want


def _host(t):
    """A result tensor as a host numpy array (bfloat16, which numpy lacks,
    widens to float32 exactly)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def load_exported(path, device=None):
    """Load an artifact; returns fn({name: array}) -> [outputs] (host
    arrays).  Needs ``paddle_tpu_torch`` imported for its operators, not
    the program that exported it."""
    srv = InferenceServer(path, device=device)
    return srv.predict


class InferenceServer(object):
    """In-process serving over an exported artifact (load once, predict
    many).

    - ``predict(feed)``: one request, synced: host arrays back.
    - ``predict_async(feed)``: launches on the current stream and returns
      the output tensors on the device without a sync; back-to-back calls
      pipeline (the next upload and launch are queued while the card
      still runs the previous one).
    - ``predict_many(feeds)`` / ``predict_stacked(stacked)``: K requests
      stacked on a leading axis, run as K launches with one sync at the
      end (``predict_stacked`` leaves even that to the caller)."""

    def __init__(self, path, device=None):
        self.path = path
        self._exported, self._module, self._meta, self.device = \
            _open_exported(path, device)
        self._avals = self._read_avals()

    def _read_avals(self):
        from torch.utils import _pytree
        ep = self._exported
        names = ep.graph_signature.user_inputs
        vals = {n.name: n.meta['val'] for n in ep.graph.nodes
                if n.op == 'placeholder'}
        specs = [FeedSpec(tuple(vals[n].shape), vals[n].dtype)
                 for n in names]
        args, _kw = _pytree.tree_unflatten(specs, ep.call_spec.in_spec)
        return dict(args[0])

    def feed_avals(self):
        """{feed_name: FeedSpec(shape, dtype)} the artifact was
        specialized on, read from its input specs: a batching layer sizes
        and types its buckets from these without the exporting program."""
        return dict(self._avals)

    def _stage(self, name, value):
        spec = self._avals.get(name)
        dtype = spec.dtype if spec is not None else None
        if not torch.is_tensor(value):
            value = torch.from_numpy(np.ascontiguousarray(value))
        return value.to(device=self.device, dtype=dtype)

    def _staged(self, feed):
        """``feed`` on the device at the artifact's dtypes, in its feed
        order (the input spec is a dict with those keys)."""
        if set(feed) != set(self._avals):
            raise ValueError("feed names %s do not match the artifact's %s"
                             % (sorted(feed), sorted(self._avals)))
        return {n: self._stage(n, feed[n]) for n in self._avals}

    def predict_async(self, feed):
        """Launch one request without waiting; returns the output tensors
        on the device.  Tensors already on the device pass through
        (cast only when their dtype differs from the artifact's)."""
        with torch.no_grad():
            return list(self._module(self._staged(feed)))

    def predict(self, feed):
        return [_host(o) for o in self.predict_async(feed)]

    def predict_many(self, feeds):
        """K feed dicts -> K output lists, one sync.  Tensors stack where
        they lie; host arrays stack on the host and upload once."""
        if not feeds:
            return []
        k = len(feeds)
        stacked = {}
        for name in feeds[0]:
            vals = [f[name] for f in feeds]
            if any(torch.is_tensor(v) for v in vals):
                stacked[name] = torch.stack([self._stage(name, v)
                                             for v in vals])
            else:
                stacked[name] = np.stack([np.asarray(v) for v in vals])
        ys = [_host(y) for y in self.predict_stacked(stacked, k)]
        return [[y[i] for y in ys] for i in range(k)]

    def predict_stacked(self, stacked, k=None):
        """K requests pre-stacked on a leading axis ({name: [K, ...]});
        returns [K, ...] output tensors on the device, no host sync.
        Inputs already on the device are taken as they are."""
        lead = {n: int(np.shape(v)[0]) for n, v in stacked.items()}
        if k is not None and any(n != int(k) for n in lead.values()):
            raise ValueError(
                "predict_stacked k=%d disagrees with the stacked leading "
                "axes %s" % (k, lead))
        if not lead:
            return []
        k = next(iter(lead.values()))
        staged = self._staged(stacked)
        outs = []
        with torch.no_grad():
            for i in range(k):
                outs.append(self._module({n: v[i]
                                          for n, v in staged.items()}))
        return [torch.stack(ys) for ys in zip(*outs)]
