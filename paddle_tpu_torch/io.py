"""Saving and loading variables, checkpoints and inference models.

Reference parity: paddle_tpu/io.py (python/paddle/v2/fluid/io.py), its
format version 3 exactly, so either package loads what the other saved:

- one ``.npy`` file a variable, named with its save generation
  (``w.g5.npy``), and ``__manifest__.json`` recording each variable's
  shape, dtype, generation and file.  A save writes the data files, then
  the manifest (tmp + rename), then sweeps generations older than the
  newest two that no manifest references; a crash before the manifest
  leaves the previous checkpoint whole.
- ``save_checkpoint(step=)`` uses step + 1 as the generation and writes
  ``STEP``; the superseded manifest and step are archived as
  ``__manifest__.json.prev`` / ``STEP.prev``, which
  ``rollback_checkpoint`` renames back.
- ``load_*`` checks each value's shape and dtype against the program's
  declaration, and puts it on the executor's place as a tensor.
  ``load_checkpoint`` binds the STEP file to the manifest's generation.
- 16-bit floats: numpy has no bfloat16 without ml_dtypes, which the
  card's host lacks.  The port writes a bfloat16 value as its raw
  ``uint16`` bits under the manifest's dtype name ``bfloat16``; the
  reference writes numpy's raw ``|V2``.  Either loads as the manifest's
  dtype, by the bits.
- A sharded record (``'shards'`` in the manifest, as the reference's
  multi-device saves write) is loaded by assembling its blocks into one
  array, which must tile the whole.  Saving shards comes with
  distribution (ROADMAP.md Queue 1 item 10); the per-process manifests
  of the reference's multi-host saves are merged on load.
- Serving version directories (the serving fleet's, inference/fleet.py):
  ``bucket_artifacts``, ``resolve_version_dir``, ``gc_versions`` and the
  ``.prev``-protocol records ``write_rollback_json`` /
  ``read_rollback_json``.  An artifact is ``bucket_<N>.pt2``, the name
  ``export_bucketed`` writes, where the reference's is
  ``bucket_<N>.stablehlo``.

The inference model is ``__model__`` (the pruned, test-mode program as
``Program.to_dict`` JSON, with the feed and fetch names) beside the
persistables it reads.
"""
import glob
import json
import os
import re
import shutil
import time

import numpy as np
import torch

from .core import datatypes
from .core.place import resolve_device
from .core.program import Parameter, Program, Variable, default_main_program
from .core.scope import global_scope

_MANIFEST = '__manifest__.json'
# v3: data filenames carry the save generation (``w.g5.npy``)
_FORMAT_VERSION = 3

__all__ = [
    'save_vars', 'save_params', 'save_persistables', 'load_vars',
    'load_params', 'load_persistables', 'load_persistables_if_exist',
    'save_inference_model', 'load_inference_model', 'get_inference_program',
    'get_parameter_value', 'get_parameter_value_by_name', 'is_parameter',
    'is_persistable', 'save_checkpoint', 'load_checkpoint',
    'rollback_checkpoint', 'step_generation', 'write_step_file',
    'bucket_artifacts', 'resolve_version_dir', 'gc_versions',
    'write_rollback_json', 'read_rollback_json',
]


def is_parameter(var):
    return isinstance(var, Parameter)


def is_persistable(var):
    return var.persistable


def _safe(name):
    return name.replace('/', '%2F')


def _host_array(value):
    """(numpy array, dtype name) of a scope value: 16-bit floats numpy
    cannot hold as their raw bits in uint16."""
    if torch.is_tensor(value):
        t = value.detach().cpu()
        name = datatypes.convert_dtype(t.dtype)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    arr = np.asarray(value)
    return arr, str(arr.dtype)


def _atomic_save(path, arr):
    """np.save through tmp + rename, so no reader sees a torn file."""
    tmp = '%s.tmp.%d' % (path, os.getpid())
    with open(tmp, 'wb') as f:
        np.save(f, arr)
    os.replace(tmp, path)


def _np_load(path, dtype):
    """A saved array as the manifest's ``dtype`` name: a numpy array, or,
    for bfloat16, the raw bits in a uint16 array (``_to_tensor`` turns
    them back).  Reinterprets by the bits when the file's dtype differs
    at the same width (the reference's raw ``|V2`` for bfloat16)."""
    arr = np.load(path)
    if dtype == 'bfloat16':
        if arr.dtype.itemsize != 2:
            raise ValueError("%s holds %s, not 16-bit bfloat16 bits"
                             % (path, arr.dtype))
        return arr.view(np.uint16)
    want = np.dtype(dtype)
    if arr.dtype != want and arr.dtype.itemsize == want.itemsize:
        arr = arr.view(want)
    return arr


def _to_tensor(arr, dtype, device):
    if dtype == 'bfloat16':
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, generation=None, scope=None):
    """Save ``vars`` (or the program's vars passing ``predicate``) from
    ``scope`` into ``dirname`` as generation ``generation`` (None: one
    past the newest in the directory)."""
    if vars is None:
        if main_program is None:
            main_program = default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    os.makedirs(dirname, exist_ok=True)
    scope = scope or global_scope()
    manifest = _read_manifest(dirname, own_only=True) or {'vars': {}}
    manifest['format_version'] = _FORMAT_VERSION
    if generation is None:
        generation = 1 + _newest_generation(_read_manifest(dirname))
    gen = int(generation)
    for var in vars:
        name = var.name if isinstance(var, Variable) else var
        value = scope.find_var(name)
        if value is None:
            continue
        arr, dtype = _host_array(value)
        fname = '%s.g%d.npy' % (_safe(name), gen)
        _atomic_save(os.path.join(dirname, fname), arr)
        manifest['vars'][name] = {'shape': [int(d) for d in arr.shape],
                                  'dtype': dtype, 'gen': gen,
                                  'file': fname}
    _write_manifest(dirname, manifest)
    _gc_stale_generations(
        dirname,
        [var.name if isinstance(var, Variable) else var for var in vars],
        floor_gen=gen)


def _referenced_generations(dirname):
    """The save generations any manifest in the directory references,
    live or archived (``.prev``)."""
    gens = set()
    esc = glob.escape(dirname)
    paths = (glob.glob(os.path.join(esc, '__manifest__*.json')) +
             glob.glob(os.path.join(esc, '__manifest__*.json.prev')))
    for path in paths:
        try:
            with open(path) as f:
                m = json.load(f)
        except (OSError, ValueError):
            continue
        for rec in m.get('vars', {}).values():
            g = rec.get('gen')
            if g is not None:
                gens.add(int(g))
    return gens


def _gc_stale_generations(dirname, names, floor_gen):
    """Delete the generation-suffixed data files of ``names`` whose
    generation is below ``floor_gen - 1`` (the save just done and the one
    before are spared) and that no manifest references.  Runs after the
    manifest write; legacy un-suffixed files are never touched."""
    try:
        entries = os.listdir(dirname)
    except OSError:
        return
    keep_gens = _referenced_generations(dirname)
    # a non-greedy name splits the generation suffix off dotted names
    pat = re.compile(
        r'^(.+?)\.(?:shard\.g(\d+)\.(?:[0-9_x]+|scalar)|g(\d+))\.npy$')
    wanted = {_safe(n) for n in names}
    # a var named like 'w.g5' saves the legacy file 'w.g5.npy', which the
    # pattern would read as generation 5 of 'w'
    legacy = {_safe(n) + '.npy' for n in names}
    floor_gen = floor_gen - 1
    for fname in entries:
        if fname in legacy:
            continue
        m = pat.match(fname)
        if not m or m.group(1) not in wanted:
            continue
        g = int(m.group(2) or m.group(3))
        if g < floor_gen and g not in keep_gens:
            try:
                os.remove(os.path.join(dirname, fname))
            except OSError:
                pass


def _write_manifest(dirname, manifest):
    """tmp + rename; the manifest it supersedes is archived as ``.prev``
    when the newest generation changes (a new checkpoint, or a rollback
    re-save), so ``.prev`` is always the last complete previous one."""
    path = os.path.join(dirname, _MANIFEST)
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(manifest, f)
    if os.path.exists(path) and _advances_generation(path, manifest):
        _archive_prev(path)
    os.replace(tmp, path)
    # a single-process save claims the directory: per-process manifests
    # of an earlier multi-host save, and their archives, would shadow it
    for stale in glob.glob(os.path.join(glob.escape(dirname),
                                        '__manifest__.p*.json*')):
        try:
            os.remove(stale)
        except OSError:
            pass


def _archive_prev(path):
    """Snapshot ``path`` as ``path.prev``: a hardlink, or a copy where the
    filesystem has none."""
    prev = path + '.prev'
    try:
        if os.path.exists(prev + '.tmp'):
            os.remove(prev + '.tmp')
        try:
            os.link(path, prev + '.tmp')
        except OSError:
            shutil.copyfile(path, prev + '.tmp')
        os.replace(prev + '.tmp', prev)
    except OSError:
        pass


def _advances_generation(path, manifest):
    """True when ``manifest``'s newest generation differs from the one on
    disk at ``path`` (an unreadable file counts as generation 0)."""
    try:
        with open(path) as f:
            on_disk = json.load(f)
    except (OSError, ValueError):
        return True
    return _newest_generation(manifest) != _newest_generation(on_disk)


def _newest_generation(manifest):
    if not manifest:
        return 0
    return max([r.get('gen', 0) or 0
                for r in manifest.get('vars', {}).values()] + [0])


def _merge_var_record(old, new):
    """Two manifests' records of one var: differing generations resolve
    to the higher wholesale; equal ones union their shard lists when
    shape, dtype and spec agree (an old block overlapping a new one is
    superseded), else the newer record wins."""
    if old is None:
        return new
    og, ng = old.get('gen'), new.get('gen')
    if og is not None and ng is not None and og != ng:
        return new if ng > og else old
    if 'shards' not in old or 'shards' not in new:
        return new
    if any(old.get(k) != new.get(k) for k in ('shape', 'dtype', 'spec')):
        return new
    new_indices = [tuple(tuple(p) for p in s['index'])
                   for s in new['shards']]
    by_index = {}
    for s in old['shards']:
        jdx = tuple(tuple(p) for p in s['index'])
        if not any(jdx != idx and _blocks_overlap(idx, jdx)
                   for idx in new_indices):
            by_index[jdx] = s
    for s, idx in zip(new['shards'], new_indices):
        by_index[idx] = s
    merged = dict(new)
    merged['shards'] = list(by_index.values())
    return merged


def _read_manifest(dirname, own_only=False):
    """The directory's manifests merged (``__manifest__.json`` and the
    reference's per-process ``__manifest__.p<K>.json`` of a multi-host
    save, oldest first, by ``_merge_var_record``), or None.  ``own_only``
    reads ``__manifest__.json`` alone (what a save seeds from).  Raises
    for a newer format."""
    if own_only:
        paths = [os.path.join(dirname, _MANIFEST)]
        paths = [p for p in paths if os.path.exists(p)]
    else:
        paths = sorted(
            glob.glob(os.path.join(glob.escape(dirname),
                                   '__manifest__*.json')),
            key=lambda p: (os.path.getmtime(p), p))
    merged = None
    for path in paths:
        with open(path) as f:
            m = json.load(f)
        if m.get('format_version', 0) > _FORMAT_VERSION:
            raise ValueError(
                "checkpoint %s was written by a newer format (version %s "
                "> %s)" % (dirname, m.get('format_version'),
                           _FORMAT_VERSION))
        if merged is None:
            merged = m
            continue
        for name, rec in m.get('vars', {}).items():
            merged['vars'][name] = _merge_var_record(
                merged['vars'].get(name), rec)
    return merged


def save_params(executor, dirname, main_program=None, generation=None,
                scope=None):
    save_vars(executor, dirname, main_program, vars=None,
              predicate=is_parameter, generation=generation, scope=scope)


def save_persistables(executor, dirname, main_program=None,
                      generation=None, scope=None):
    save_vars(executor, dirname, main_program, vars=None,
              predicate=is_persistable, generation=generation, scope=scope)


def _check_against_program(name, var, shape, dtype):
    """Raise when a saved value disagrees with the program's declaration
    (a -1 or 0 dim matches any size)."""
    if not isinstance(var, Variable):
        return
    decl = tuple(int(d) for d in (var.shape or ()))
    if decl:
        got = tuple(shape)
        ok = len(decl) == len(got) and all(
            d in (-1, 0) or d == g for d, g in zip(decl, got))
        if not ok:
            raise ValueError(
                "checkpoint var '%s' has shape %s but the program declares "
                "%s — the model changed since this checkpoint was saved" %
                (name, got, decl))
    want = datatypes.convert_dtype(var.dtype)
    got = datatypes.convert_dtype(dtype)
    if got != want:
        raise ValueError(
            "checkpoint var '%s' has dtype %s but the program declares %s"
            % (name, got, want))


def _blocks_overlap(idx, jdx):
    return all(a < d and c < b for (a, b), (c, d) in zip(idx, jdx))


def _assemble(shape, dtype, shard_files):
    """Stitch shard blocks ({index: path}) into the full array; they must
    lie in bounds, be disjoint and cover the whole."""
    full = None
    covered = 0
    blocks = list(shard_files.items())
    for i, (idx, path) in enumerate(blocks):
        if len(idx) != len(shape) or any(
                not (0 <= a <= b <= dim) for (a, b), dim in zip(idx, shape)):
            raise ValueError(
                "checkpoint shard %s has index %s outside shape %s"
                % (os.path.basename(path), idx, shape))
        for jdx, other in blocks[:i]:
            if _blocks_overlap(idx, jdx):
                raise ValueError(
                    "checkpoint shards %s and %s overlap (indices %s, %s)"
                    % (os.path.basename(path), os.path.basename(other),
                       idx, jdx))
        block = _np_load(path, dtype)
        want = tuple(b - a for a, b in idx)
        if block.shape != want:
            raise ValueError(
                "checkpoint shard %s has shape %s but its index %s spans %s"
                % (os.path.basename(path), block.shape, idx, want))
        if full is None:
            full = np.empty(shape, dtype=block.dtype)
        full[tuple(slice(a, b) for a, b in idx)] = block
        covered += int(np.prod(want))
    total = int(np.prod(shape))
    if covered != total:
        raise ValueError(
            "checkpoint shards cover %d of %d elements — the checkpoint is "
            "incomplete (a host's shards or manifest are missing)"
            % (covered, total))
    return full


def _load_sharded(dirname, name, rec):
    def path(s):
        # format v1 wrote integer counters ('x.shard3.npy')
        if isinstance(s['file'], int):
            return os.path.join(dirname,
                                '%s.shard%d.npy' % (_safe(name), s['file']))
        return os.path.join(dirname, s['file'])

    shard_files = {tuple(tuple(p) for p in s['index']): path(s)
                   for s in rec['shards']}
    return _assemble(tuple(rec['shape']), rec['dtype'], shard_files)


def _place(executor):
    return resolve_device(getattr(executor, 'place', None))


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, scope=None, manifest=None):
    """Restore ``vars`` (or the program's vars passing ``predicate``) into
    ``scope`` as tensors on the executor's place; returns how many were
    restored (a var absent from the directory is skipped).  ``manifest``
    pins the manifest to resolve against (None reads the directory)."""
    if vars is None:
        if main_program is None:
            main_program = default_main_program()
        vars = list(filter(predicate, main_program.list_vars()))
    scope = scope or global_scope()
    if manifest is None:
        manifest = _read_manifest(dirname)
    records = manifest['vars'] if manifest else {}
    device = _place(executor)
    loaded = 0
    for var in vars:
        name = var.name if isinstance(var, Variable) else var
        rec = records.get(name)
        if rec is not None and rec.get('shards'):
            arr = _load_sharded(dirname, name, rec)
            dtype = rec['dtype']
        else:
            # a v3 record names its generation's file; the un-suffixed
            # legacy name serves only records without one
            if rec is not None and rec.get('file'):
                path = os.path.join(dirname, rec['file'])
            else:
                path = os.path.join(dirname, _safe(name) + '.npy')
            if not os.path.exists(path):
                continue
            if rec is not None:
                dtype = rec['dtype']
                arr = _np_load(path, dtype)
            else:
                arr = np.load(path)
                dtype = str(arr.dtype)
        if rec is not None:
            _check_against_program(name, var, rec['shape'], dtype)
        scope.set(name, _to_tensor(arr, dtype, device))
        loaded += 1
    return loaded


def load_params(executor, dirname, main_program=None, scope=None):
    load_vars(executor, dirname, main_program, predicate=is_parameter,
              scope=scope)


def load_persistables(executor, dirname, main_program=None, scope=None,
                      manifest=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_persistable, scope=scope,
                     manifest=manifest)


def load_persistables_if_exist(executor, dirname, main_program=None):
    if os.path.isdir(dirname):
        load_persistables(executor, dirname, main_program)


def get_inference_program(target_vars, main_program=None):
    """``main_program`` pruned to ``target_vars``, in test mode."""
    if main_program is None:
        main_program = default_main_program()
    if not isinstance(target_vars, list):
        target_vars = [target_vars]
    return main_program.prune(targets=target_vars).inference_optimize()


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None):
    """Write ``__model__`` (the program pruned to ``target_vars`` from
    ``feeded_var_names``, in test mode) and the persistables it reads;
    returns that program."""
    if isinstance(feeded_var_names, str):
        feeded_var_names = [feeded_var_names]
    if isinstance(target_vars, Variable):
        target_vars = [target_vars]
    if main_program is None:
        main_program = default_main_program()
    os.makedirs(dirname, exist_ok=True)
    pruned = main_program.prune(targets=target_vars, feeds=feeded_var_names)
    inference_program = pruned.inference_optimize()
    meta = dict(program=inference_program.to_dict(),
                feed_var_names=list(feeded_var_names),
                fetch_var_names=[v.name for v in target_vars])
    with open(os.path.join(dirname, '__model__'), 'w') as f:
        json.dump(meta, f)
    save_persistables(executor, dirname, inference_program)
    return inference_program


def load_inference_model(dirname, executor):
    """(program, feed names, fetch Variables) of a saved inference model;
    its persistables go into the global scope on the executor's place."""
    with open(os.path.join(dirname, '__model__')) as f:
        meta = json.load(f)
    program = Program.from_dict(meta['program'])
    load_persistables(executor, dirname, program)
    fetch_vars = [program.global_block().var(n)
                  for n in meta['fetch_var_names']]
    return program, meta['feed_var_names'], fetch_vars


def get_parameter_value(para, executor=None):
    assert is_parameter(para)
    return global_scope().get_numpy(para.name)


def get_parameter_value_by_name(name, executor=None, program=None):
    if program is None:
        program = default_main_program()
    return get_parameter_value(program.global_block().var(name), executor)


# -- checkpoint / resume -------------------------------------------------
def step_generation(step):
    """The save generation a training step maps to."""
    return None if step is None else int(step) + 1


def write_step_file(dirname, step):
    """Record the checkpoint's step, archiving a different previous one as
    ``STEP.prev`` (tmp + rename: the archive may be a hardlink)."""
    path = os.path.join(dirname, 'STEP')
    if os.path.exists(path):
        try:
            with open(path) as f:
                on_disk = int(f.read().strip())
        except (OSError, ValueError):
            on_disk = None
        if on_disk is None or int(step) != on_disk:
            _archive_prev(path)
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        f.write(str(int(step)))
    os.replace(tmp, path)


def save_checkpoint(executor, dirname, main_program=None, step=None,
                    scope=None):
    """Every persistable (parameters, optimizer moments, batch-norm
    statistics, counters), as generation ``step + 1``, and ``STEP``."""
    save_persistables(executor, dirname, main_program,
                      generation=step_generation(step), scope=scope)
    if step is not None:
        write_step_file(dirname, step)


def _read_step_file(dirname, prev=False):
    path = os.path.join(dirname, 'STEP' + ('.prev' if prev else ''))
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def load_checkpoint(executor, dirname, main_program=None, scope=None):
    """Restore every persistable and return the checkpoint's step.  The
    load is accepted only when ``step_generation(STEP)`` equals the
    newest generation of the manifest it read (retried on a mismatch, a
    save or rollback caught mid-rename); a checkpoint saved without a
    step loads as it is."""
    last_err = None
    for _attempt in range(8):
        manifest = _read_manifest(dirname)
        try:
            n = load_persistables(executor, dirname, main_program,
                                  scope=scope, manifest=manifest)
        except OSError as e:
            # a concurrent save swept this manifest's files: read again
            last_err = e
            time.sleep(0.005)
            continue
        if n == 0:
            last_err = ValueError(
                "checkpoint %s restored nothing — no persistable var of "
                "the program matches a saved name (was the program "
                "rebuilt with different auto-generated names? build it "
                "under reset_unique_name_guard() for stable names)"
                % dirname)
            if not os.path.exists(os.path.join(dirname, _MANIFEST)):
                raise last_err
            time.sleep(0.005)
            continue
        step = _read_step_file(dirname)
        gen = _newest_generation(manifest)
        if step is None or gen == 0:
            return step
        if step_generation(step) == gen:
            return step
        last_err = RuntimeError(
            "checkpoint %s is mid-update: STEP %d does not match the "
            "manifest generation %d" % (dirname, step, gen))
        time.sleep(0.005)
    if isinstance(last_err, ValueError):
        raise last_err
    raise RuntimeError(
        "checkpoint %s kept changing under the reader — could not observe "
        "a consistent (params, step) pair in 8 attempts (last: %s)"
        % (dirname, last_err))


def rollback_checkpoint(dirname):
    """Rename the archived ``__manifest__.json.prev`` / ``STEP.prev`` back
    over the live files and return the restored step (None when the
    archive has none).  Raises when there is no archive."""
    man = os.path.join(dirname, _MANIFEST)
    prev = man + '.prev'
    if not os.path.exists(prev):
        raise ValueError(
            "no %s.prev archive in %s — nothing to roll back to (only a "
            "save that SUPERSEDED a checkpoint leaves an archive)"
            % (_MANIFEST, dirname))
    os.replace(prev, man)
    step_prev = os.path.join(dirname, 'STEP.prev')
    step_live = os.path.join(dirname, 'STEP')
    if os.path.exists(step_prev):
        os.replace(step_prev, step_live)
    else:
        # the restored checkpoint has no step: a live STEP belongs to the
        # save just rolled back
        try:
            os.remove(step_live)
        except OSError:
            pass
    return _read_step_file(dirname)


# -- serving version directories (inference/fleet.py) ---------------------
_BUCKET_RE = re.compile(r'^bucket_(\d+)\.pt2$')


def bucket_artifacts(dirname):
    """{bucket_size: path} of the ``export_bucketed`` artifacts in a
    directory (``bucket_<N>.pt2``): one servable model version.  Empty
    when the directory holds none (the is-this-a-version-dir test)."""
    out = {}
    try:
        entries = os.listdir(dirname)
    except OSError:
        return out
    for fname in entries:
        m = _BUCKET_RE.match(fname)
        if m:
            out[int(m.group(1))] = os.path.join(dirname, fname)
    return out


def resolve_version_dir(path, version=None):
    """``(version_dir, version_name)`` of a servable, TF-Serving style.

    ``path`` is an ``export_bucketed`` directory, or a base directory of
    versions (``base/1``, ``base/2``, ...; the highest number is the
    newest).  ``version`` names a subdirectory, checked; a directory of
    artifacts is itself, named by its basename; otherwise the
    numerically highest subdirectory holding artifacts (non-numeric
    names rank below every number, so a ``canary/`` beside ``1..N`` never
    wins by accident)."""
    if version is not None:
        d = os.path.join(path, str(version))
        if not bucket_artifacts(d):
            raise ValueError(
                "version %r under %s has no bucket_<N>.pt2 artifacts "
                "(export_bucketed writes them)" % (version, path))
        return d, str(version)
    if bucket_artifacts(path):
        name = os.path.basename(os.path.abspath(path).rstrip(os.sep))
        return path, name
    try:
        entries = sorted(os.listdir(path))
    except OSError:
        raise ValueError("version path %s is not a directory" % (path,))
    candidates = [e for e in entries
                  if os.path.isdir(os.path.join(path, e))
                  and bucket_artifacts(os.path.join(path, e))]
    if not candidates:
        raise ValueError(
            "%s holds neither bucket_<N>.pt2 artifacts nor versioned "
            "subdirectories containing them: point the fleet at an "
            "export_bucketed directory or a base directory of numbered "
            "versions" % (path,))
    candidates.sort(key=lambda e: (1, int(e)) if e.isdigit() else (0, e))
    best = candidates[-1]
    return os.path.join(path, best), best


def gc_versions(base_dir, keep=4, protect=()):
    """Keep the ``keep`` numerically newest version directories of a base
    directory and delete the rest; returns the names removed.

    Never removed: a name or path in ``protect`` (a fleet's
    ``protected_version_dirs()``: its live directories and the current
    and ``.prev`` targets of its deploy records); the highest version
    (``keep`` is at least 1), which a concurrent ``resolve_version_dir``
    may be loading; non-numeric names and directories without artifacts
    (a version an exporter is still writing).  A victim is renamed to
    ``<name>.gc.<pid>`` before its removal, so a concurrent resolve sees
    the whole version or none of it; such a leftover of a crashed GC is
    finished here.  The AOT cache's entries for removed artifacts go with
    ``AotCache.sweep_orphans``."""
    keep = max(1, int(keep))
    prot_names, prot_paths = set(), set()
    for p in protect:
        if p is None:
            continue
        p = str(p)
        if os.sep in p or p == '.':
            prot_paths.add(os.path.abspath(p.rstrip(os.sep)))
            prot_names.add(os.path.basename(p.rstrip(os.sep)))
        else:
            prot_names.add(p)
    try:
        entries = os.listdir(base_dir)
    except OSError:
        return []
    versions = []
    tomb = re.compile(r'^\d+\.gc\.\d+$')
    for e in entries:
        d = os.path.join(base_dir, e)
        if e.isdigit() and os.path.isdir(d) and bucket_artifacts(d):
            versions.append((int(e), e, d))
        elif tomb.match(e) and os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)
    versions.sort()
    removed = []
    for _num, name, d in versions[:-keep]:
        if name in prot_names or os.path.abspath(d) in prot_paths:
            continue
        victim = '%s.gc.%d' % (d, os.getpid())
        try:
            os.rename(d, victim)
        except OSError:
            continue   # a concurrent GC or deploy won it
        shutil.rmtree(victim, ignore_errors=True)
        removed.append(name)
    return removed


def write_rollback_json(path, obj):
    """Write a small JSON record under the ``.prev`` protocol of the STEP
    file: when the content changes, the superseded file is archived as
    ``<path>.prev`` first, then the new content lands by tmp + rename.
    Rewriting the same content leaves the archive alone."""
    changed = True
    if os.path.exists(path):
        try:
            with open(path) as f:
                changed = json.load(f) != obj
        except (OSError, ValueError):
            changed = True   # unreadable counts as a change
        if changed:
            _archive_prev(path)
    tmp = '%s.tmp.%d' % (path, os.getpid())
    with open(tmp, 'w') as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def read_rollback_json(path, prev=False):
    """A ``write_rollback_json`` record, or with ``prev=True`` its
    ``.prev`` archive; None when that file does not exist."""
    p = path + '.prev' if prev else path
    try:
        with open(p) as f:
            return json.load(f)
    except OSError:
        return None
