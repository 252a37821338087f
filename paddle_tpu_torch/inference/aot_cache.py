"""The AOT cache of readied serving buckets: a cold start without
``torch.export.load``.

Reference parity: paddle_tpu/inference/aot_cache.py, its contract: one
file a key under ``<dir>/paddle_tpu_aot/`` (``<dir>`` is
PADDLE_TPU_TORCH_AOT_CACHE_DIR), a JSON header line and then the body;
atomic writes (``tmp.<pid>`` + ``os.replace``); a header or body that does
not parse is a counted ``corrupt`` and reads as a miss; a header for
another schema, torch or CUDA version or device kind is a counted miss;
``sweep_orphans`` removes other writers' ``.tmp.*`` leftovers and entries
whose source artifact is gone; ``stats()`` counts hits, misses, corrupt
entries, stores and orphans process-wide.

What an entry holds.  The reference serializes XLA's compiled executable.
Here a bucket is readied by loading its ``torch.export`` artifact
(``torch.export.load``: the graph's deserialization and the state),
unlifting it (``ExportedProgram.module()``: a graph module generated
from it), putting the state on the device and calling it once (the
warm call).  An entry persists the product of the first two: the lifted
graph's Python code, which ``exec`` turns back into its function, and the
state tensors in the graph's argument order, with the feed names and the
positions of the user outputs.  A hit runs the same aten and
``paddle_tpu_torch`` operators in the same order as the unlifted module,
so its answers are bitwise the cold path's.  What no file can hold stays
in the hit path, in the warm call that follows it: the CUDA context,
CUDA's lazy loading of the kernels' modules, cuDNN's handles and its
choice of algorithms, the ``dlopen`` of the port's own kernel libraries
(``build/kernels/``).  No ``torch.compile`` and no AOTInductor: their
generated kernels would change numbers that stay bitwise
``Executor.run``'s.

The key is the artifact's sha1 (its content: the program after the pass
pipeline and its state), the bucket, the device kind
(``torch.cuda.get_device_name`` on the card, ``'cpu'`` on the CPU), the
torch version and the CUDA version, with the schema: any drift is a plain
miss and a load from the artifact, never a wrong module.
"""
import hashlib
import io
import json
import os

import torch

from .. import observability as _obs
from ..flags import FLAGS
from .serving import FeedSpec, InferenceServer

__all__ = ['AotCache', 'artifact_digest', 'device_kind']

_SCHEMA = 1

# process-wide counters; tests and the fleet read them through stats(),
# and they are mirrored into the observability registry when metrics are
# enabled (the reference's series)
_STATS = {'hits': 0, 'misses': 0, 'corrupt': 0, 'stores': 0,
          'orphans': 0}


def _count(which):
    _STATS[which] += 1
    if not _obs.enabled():
        return
    name = {'hits': 'paddle_tpu_aot_cache_hits_total',
            'misses': 'paddle_tpu_aot_cache_misses_total',
            'corrupt': 'paddle_tpu_aot_cache_corrupt_total',
            'stores': 'paddle_tpu_aot_cache_stores_total',
            'orphans': 'paddle_tpu_aot_cache_orphans_total'}[which]
    _obs.registry().counter(
        name, 'serving AOT executable cache %s' % which).inc()


def device_kind(device):
    """The device part of a key: the card's name, or ``'cpu'``."""
    device = torch.device(device)
    if device.type == 'cuda':
        return torch.cuda.get_device_name(device)
    return device.type


def _versions():
    return {'torch': torch.__version__, 'cuda': torch.version.cuda}


def artifact_digest(path, _bufsize=1 << 20):
    """sha1 of a bucket artifact's bytes: the content part of a key."""
    h = hashlib.sha1()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(_bufsize), b''):
            h.update(chunk)
    return h.hexdigest()


class _CachedModule(torch.nn.Module):
    """An entry made callable as ``ExportedProgram.module()`` is:
    ``forward(feed) -> tuple of outputs``, the state held as buffers.
    The lifted graph's function takes the state and the feeds in its
    placeholders' order (``slots``: an int is a state index, a string a
    feed name) and returns every output of the graph, of which
    ``outputs`` are the user's."""

    def __init__(self, fn, state, slots, outputs, avals):
        super(_CachedModule, self).__init__()
        self._fn = fn
        self._n_state = len(state)
        for i, t in enumerate(state):
            self.register_buffer('s%d' % i, t)
        self._slots = list(slots)
        self._outputs = list(outputs)
        self._shapes = {n: tuple(a.shape) for n, a in avals.items()}

    def forward(self, feed):
        for n, shape in self._shapes.items():
            if tuple(feed[n].shape) != shape:
                raise ValueError("feed %r has shape %s; the entry was "
                                 "readied for %s" % (n, tuple(feed[n].shape),
                                                     shape))
        state = [getattr(self, 's%d' % i) for i in range(self._n_state)]
        args = [feed[s] if isinstance(s, str) else state[s]
                for s in self._slots]
        outs = self._fn(self, *args)
        return tuple(outs[i] for i in self._outputs)


def _payload(exported):
    """The body's content for an ExportedProgram: the lifted graph's code
    with its imports, the state on the host in argument order, the slots
    and the user outputs.  Raises where the graph holds what the code
    alone cannot restore (a submodule or an attribute)."""
    from torch.export.graph_signature import InputKind, OutputKind
    from torch.fx.graph_module import _format_import_block
    from torch.package import sys_importer
    gm = exported.graph_module
    if any(n.op in ('get_attr', 'call_module') for n in gm.graph.nodes):
        raise TypeError("the graph reads module attributes")
    pc = gm.graph.python_code(root_module='self')
    code = _format_import_block(pc.globals, sys_importer) + pc.src
    sig = exported.graph_signature
    state, slots = [], []
    for spec in sig.input_specs:
        if spec.kind == InputKind.USER_INPUT:
            slots.append(None)   # filled from the in_spec below
            continue
        src = (exported.constants if spec.kind == InputKind.CONSTANT_TENSOR
               else exported.state_dict)
        slots.append(len(state))
        state.append(src[spec.target].detach().cpu())
    from torch.utils import _pytree
    n_user = slots.count(None)
    args, _ = _pytree.tree_unflatten(list(range(n_user)),
                                     exported.call_spec.in_spec)
    names = sorted(args[0], key=args[0].get)
    it = iter(names)
    slots = [next(it) if s is None else s for s in slots]
    outputs = [i for i, s in enumerate(sig.output_specs)
               if s.kind == OutputKind.USER_OUTPUT]
    return {'code': code, 'state': state, 'slots': slots,
            'outputs': outputs}


def _build(body, path, avals, meta, device):
    """An InferenceServer over a parsed entry body, on ``device``."""
    glb = {}
    exec(compile(body['code'], '<aot %s>' % os.path.basename(path), 'exec'),
         glb)
    state = [t.to(device) for t in body['state']]
    module = _CachedModule(glb['forward'], state, body['slots'],
                           body['outputs'], avals)
    return InferenceServer._from_module(path, module, avals, meta, device)


class AotCache(object):
    """Load and store readied buckets keyed by (artifact digest, bucket,
    device kind, torch version, CUDA version).

    ``root=None`` reads PADDLE_TPU_TORCH_AOT_CACHE_DIR; an empty root
    disables the cache (``enabled()`` False, loads None, stores no-ops)."""

    def __init__(self, root=None):
        if root is None:
            root = FLAGS.aot_cache_dir or ''
        self.root = os.path.join(root, 'paddle_tpu_aot') if root else ''

    def enabled(self):
        return bool(self.root)

    @staticmethod
    def key(artifact_sha1, bucket, device_kind):
        """Digest of the key's parts, the schema included, so that a
        format change re-keys everything instead of half matching."""
        v = _versions()
        blob = repr((_SCHEMA, str(artifact_sha1), int(bucket),
                     str(device_kind), v['torch'], v['cuda']))
        return hashlib.sha1(blob.encode()).hexdigest()

    def path(self, key):
        return os.path.join(self.root, 'aot_%s.bin' % key) \
            if self.root else None

    @staticmethod
    def stats():
        """Process-wide {'hits', 'misses', 'corrupt', 'stores',
        'orphans'}."""
        return dict(_STATS)

    def load_compiled(self, key, device):
        """The entry of ``key`` readied as an :class:`InferenceServer` on
        ``device`` (its state there, not yet warm), or None on a miss.  A
        corrupt entry is counted and reads as a miss; a header for
        another schema, version or device kind is a counted miss."""
        p = self.path(key)
        if p is None:
            return None
        device = torch.device(device)
        try:
            with open(p, 'rb') as f:
                header = f.readline()
                body = f.read()
        except FileNotFoundError:
            _count('misses')
            return None
        except OSError:
            _count('corrupt')
            return None
        try:
            hdr = json.loads(header.decode('utf-8'))
        except (ValueError, UnicodeDecodeError):
            _count('corrupt')
            return None
        want = dict(_versions(), schema=_SCHEMA,
                    device_kind=device_kind(device))
        if not isinstance(hdr, dict) or \
                any(hdr.get(k) != v for k, v in want.items()):
            _count('misses')
            return None
        try:
            parsed = torch.load(io.BytesIO(body), map_location='cpu',
                                weights_only=True)
            avals = {n: FeedSpec(shape, _dtype(dt))
                     for n, (shape, dt) in hdr['avals'].items()}
            srv = _build(parsed, hdr.get('artifact') or p, avals,
                         hdr.get('meta') or {}, device)
        except Exception:
            _count('corrupt')
            return None
        _count('hits')
        return srv

    def store(self, key, compiled, artifact=None, bucket=None):
        """Atomically persist a loaded bucket (``compiled``: its
        ``InferenceServer``, loaded from the artifact) under ``key``.
        False, with nothing written, when the cache is off, the server
        cannot be persisted or the directory is not writable.
        ``artifact`` ties the entry's life to its source file for
        :meth:`sweep_orphans`."""
        p = self.path(key)
        if p is None:
            return False
        try:
            payload = _payload(compiled._exported)
            buf = io.BytesIO()
            torch.save(payload, buf)
            avals = {n: [list(a.shape), str(a.dtype).replace('torch.', '')]
                     for n, a in compiled.feed_avals().items()}
            hdr = dict(_versions(), schema=_SCHEMA,
                       device_kind=device_kind(compiled.device),
                       artifact=(os.path.abspath(artifact)
                                 if artifact else None),
                       bucket=int(bucket) if bucket is not None else None,
                       avals=avals, meta=dict(compiled._meta))
        except Exception:
            return False   # not a persistable server: a quiet no-op
        try:
            os.makedirs(self.root, exist_ok=True)
            tmp = p + '.tmp.%d' % os.getpid()
            with open(tmp, 'wb') as f:
                f.write(json.dumps(hdr, sort_keys=True).encode() + b'\n')
                f.write(buf.getbuffer())
            os.replace(tmp, p)
        except OSError:
            return False
        _count('stores')
        return True

    def sweep_orphans(self):
        """Remove other processes' ``.tmp.*`` leftovers (this process's
        own write in flight is kept) and entries whose recorded artifact
        no longer exists (its version directory was collected), and
        entries whose header does not parse (counted corrupt).  An entry
        stored without an artifact is kept; files not named like entries
        are never touched.  Returns the removed names."""
        if not self.root:
            return []
        try:
            entries = os.listdir(self.root)
        except OSError:
            return []
        removed = []
        own_tmp = '.tmp.%d' % os.getpid()
        for e in sorted(entries):
            p = os.path.join(self.root, e)
            if '.tmp.' in e:
                if e.endswith(own_tmp):
                    continue
                if _remove(p):
                    removed.append(e)
                continue
            if not (e.startswith('aot_') and e.endswith('.bin')):
                continue
            try:
                with open(p, 'rb') as f:
                    hdr = json.loads(f.readline().decode('utf-8'))
                art = hdr.get('artifact') if isinstance(hdr, dict) else ''
            except (OSError, ValueError, UnicodeDecodeError):
                art = ''
                _count('corrupt')
            if art is None:
                continue
            if (art == '' or not os.path.exists(art)) and _remove(p):
                removed.append(e)
        return removed


def _remove(p):
    try:
        os.remove(p)
    except OSError:
        return False
    _count('orphans')
    return True


def _dtype(name):
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError("not a dtype: %r" % (name,))
    return dt

