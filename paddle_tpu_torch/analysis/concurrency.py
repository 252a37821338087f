"""Static concurrency analyzer: guarded-by inference and lock ordering.

The port's own copy of paddle_tpu/analysis/concurrency.py (the port
imports nothing of the JAX package); on any source its findings, waivers,
entrypoints, order edges and guarded-by map equal the reference's.  It
is an Eraser-style lockset analysis (Savage et al.) with ``@GuardedBy``
checking, over the threaded serving and runtime code:

1. **Thread entrypoints**: every ``threading.Thread(target=X)`` site,
   ``X`` a bound method or a local worker function.  Every non-init
   method of a lock-owning class is a thread-reachable path.
2. **Guarded-by inference**: per class owning a lock attribute
   (``threading.Lock/RLock/Condition``, a ``lockdebug.make_*``
   factory, or any ``with self._x:`` context), each ``self._field``
   access with the locks lexically held.  Conditions over one shared
   lock form one alias group.  Private helpers whose every intra-class
   call site holds a lock inherit it; bodies of ``lambda`` / nested
   ``def`` and escaping method references inherit nothing.  A field
   written under lock ``L`` on one non-init path and accessed without
   ``L`` on another is a finding; ``__init__`` and helpers reachable only
   from it are exempt.
3. **Lock-order graph**: nested ``with`` acquisitions add edges,
   lexically and through a per-class one-level call graph; a cycle is a
   potential deadlock.  :mod:`lockdebug` asserts the same edges at run
   time.
4. **Waivers** on the line that assigns the field (or the line above):
   ``# lock: guarded_by(_lock)`` declares and enforces the guard;
   ``# lock: unguarded-ok(<reason>)`` waives the field with its reason,
   and an empty reason is itself a finding.

Guarded-by is class-scoped; module-level locks still join the order
graph.  ``python -m paddle_tpu_torch.tools.check_concurrency`` sweeps the
port's package and fails on any unwaived finding.
"""
import ast
import os
import re
from collections import namedtuple

__all__ = ['analyze_source', 'analyze_paths', 'analyze_package',
           'Finding', 'Report', 'package_root']

# -- annotation grammar ----------------------------------------------------
_ANNOT_RE = re.compile(
    r'#\s*lock:\s*(guarded_by|unguarded-ok)\s*\(([^)]*)\)')

# method names that mutate their receiver container in place: a
# ``self._pending.append(r)`` is a WRITE to the _pending deque for
# lockset purposes.  Synchronization primitives' own verbs (Queue
# put/get, Event set/wait) are deliberately absent — those objects are
# their own guard.
_MUTATORS = frozenset({
    'append', 'appendleft', 'extend', 'extendleft', 'insert', 'add',
    'discard', 'remove', 'pop', 'popleft', 'popitem', 'clear',
    'update', 'setdefault', 'push', 'sort', 'reverse',
})

Finding = namedtuple(
    'Finding',
    ['kind',      # unguarded-write | unguarded-read | lock-order-cycle
                  # | bad-waiver | bad-annotation
     'path', 'lineno', 'cls', 'field', 'lock', 'method', 'message'])

_Access = namedtuple('_Access', ['field', 'method', 'lineno', 'kind',
                                 'held'])
# spec: ('self', m) intra-class call | ('ref', m) deferred/escaping
# reference | ('attr', attrname, m) call through a typed attribute |
# ('class', ClassName, m) call on a locally constructed instance
_Call = namedtuple('_Call', ['spec', 'held', 'lineno', 'method'])


class Report(object):
    """Everything one sweep produced."""

    def __init__(self):
        self.findings = []        # unwaived Finding list (the verdict)
        self.waived = []          # (Finding, reason) documented debts
        self.entrypoints = []     # (path, lineno, target description)
        self.order_edges = {}     # (src, dst) -> [(path, lineno)]
        self.guarded_by = {}      # 'Class.field' -> lock group label
        self.classes = 0          # lock-owning classes analyzed

    def errors(self):
        """Human-readable strings, one per unwaived finding (empty =
        the sweep is clean)."""
        return ['%s:%s: [%s] %s' % (f.path, f.lineno, f.kind, f.message)
                for f in self.findings]


# -- per-class scaffolding -------------------------------------------------
class _Groups(object):
    """Union-find over lock attribute names; canonical name = the first
    attr registered into the group (assignment order)."""

    def __init__(self):
        self._parent = {}
        self._order = []

    def __contains__(self, name):
        return name in self._parent

    def add(self, name):
        if name not in self._parent:
            self._parent[name] = name
            self._order.append(name)
        return self.find(name)

    def find(self, name):
        p = self._parent
        while p[name] != name:
            p[name] = p[p[name]]
            name = p[name]
        return name

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return ra
        if self._order.index(ra) > self._order.index(rb):
            ra, rb = rb, ra
        self._parent[rb] = ra
        return ra

    def members(self, root):
        if root not in self._parent:
            return [root]
        return sorted(n for n in self._parent
                      if self.find(n) == self.find(root))

    def names(self):
        return list(self._parent)


class _ClassInfo(object):
    def __init__(self, name, node, path):
        self.name = name
        self.node = node
        self.path = path
        self.methods = {}        # name -> FunctionDef
        self.groups = _Groups()  # lock attrs (alias-aware)
        self.accesses = []       # [_Access]
        self.calls = []          # [_Call]
        self.acquires = {}       # method -> set(group key)
        self.thread_roots = set()
        self.attr_types = {}     # attr -> ClassName
        self.field_lines = {}    # lineno -> field (self.X = ... sites)
        self.annotations = {}    # field -> (form, arg, lineno)
        self.order_sites = []    # (src key, dst key, lineno)

    def lock_attr(self, attr):
        return attr in self.groups


def _is_self(node):
    return isinstance(node, ast.Name) and node.id in ('self', 'cls')


def _self_attr(node):
    """attr name when ``node`` is ``self.X`` / ``cls.X``, else None."""
    if isinstance(node, ast.Attribute) and _is_self(node.value):
        return node.attr
    return None


def _call_name(func):
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ''


def _lock_ctor_kind(call):
    """'lock' | 'condition' | None for a Call constructing a lock
    (threading.* or a lockdebug.make_* factory, any module alias)."""
    if not isinstance(call, ast.Call):
        return None
    name = _call_name(call.func)
    if name in ('Lock', 'RLock', 'make_lock', 'make_rlock'):
        return 'lock'
    if name in ('Condition', 'make_condition'):
        return 'condition'
    return None


def _condition_lock_arg(call):
    """The lock argument of Condition(lock) / make_condition(name,
    lock=...), if present."""
    name = _call_name(call.func)
    if name == 'Condition':
        return call.args[0] if call.args else None
    if name == 'make_condition':
        if len(call.args) >= 2:
            return call.args[1]
        for kw in call.keywords:
            if kw.arg == 'lock':
                return kw.value
    return None


def _class_of_value(value, known_classes):
    """ClassName when ``value`` (possibly behind BoolOp/IfExp)
    constructs a known class."""
    if not isinstance(value, (ast.Call, ast.BoolOp, ast.IfExp)):
        return None
    for node in ast.walk(value):
        if isinstance(node, ast.Call):
            name = _call_name(node.func)
            if name in known_classes:
                return name
    return None


# -- pass 1: lock discovery ------------------------------------------------
def _discover_locks(ci, known_classes):
    for stmt in ci.node.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ci.methods[stmt.name] = stmt
        elif isinstance(stmt, ast.Assign):
            # class-body lock: ``_cache_lock = threading.Lock()``
            if _lock_ctor_kind(stmt.value):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        ci.groups.add(t.id)

    for mname, m in ci.methods.items():
        local_locks = {}  # local var -> group root
        for node in ast.walk(m):
            if not isinstance(node, ast.Assign):
                continue
            kind = _lock_ctor_kind(node.value)
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None:
                    ci.field_lines.setdefault(t.lineno, attr)
                    if kind is not None:
                        root = ci.groups.add(attr)
                        la = _condition_lock_arg(node.value) \
                            if kind == 'condition' else None
                        if la is not None:
                            alias = None
                            if isinstance(la, ast.Name):
                                alias = local_locks.get(la.id)
                            else:
                                aattr = _self_attr(la)
                                if aattr is not None:
                                    alias = ci.groups.add(aattr)
                            if alias is not None:
                                ci.groups.union(alias, root)
                    else:
                        tcls = _class_of_value(node.value,
                                               known_classes)
                        if tcls is not None:
                            ci.attr_types.setdefault(t.attr, tcls)
                elif isinstance(t, ast.Name) and kind is not None:
                    local_locks[t.id] = ci.groups.add(
                        '<local:%s:%s>' % (mname, t.id))
                elif isinstance(t, (ast.Tuple, ast.List)):
                    for el in t.elts:
                        a = _self_attr(el)
                        if a is not None:
                            ci.field_lines.setdefault(el.lineno, a)

    # any attr used as a ``with self.X:`` context is a lock even when
    # its constructor was not recognized (``self._lock = lock`` taking
    # a caller-provided lock)
    for m in ci.methods.values():
        for node in ast.walk(m):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None:
                        ci.groups.add(attr)


def _discover_thread_targets(tree, path, classes, report):
    """threading.Thread(target=X) sites: mark bound-method targets as
    class thread roots; record every entrypoint for the report."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _call_name(node.func) == 'Thread'):
            continue
        target = None
        for kw in node.keywords:
            if kw.arg == 'target':
                target = kw.value
        if target is None:
            continue
        desc = None
        attr = _self_attr(target)
        if attr is not None:
            for ci in classes.values():
                if attr in ci.methods and \
                        any(n is node for n in ast.walk(ci.node)):
                    ci.thread_roots.add(attr)
                    desc = '%s.%s' % (ci.name, attr)
                    break
            desc = desc or 'self.%s' % attr
        elif isinstance(target, ast.Name):
            desc = target.id
        elif isinstance(target, ast.Attribute):
            desc = target.attr
        else:
            desc = '<expr>'
        report.entrypoints.append((path, node.lineno, desc))


# -- pass 2: held-lock walk ------------------------------------------------
class _MethodWalker(object):
    """Walk one method body tracking the lexically held lock groups,
    recording field accesses, calls, acquisitions, and
    nested-acquisition order sites."""

    def __init__(self, ci, mname, module_locks, modname,
                 known_classes, backrefs):
        self.ci = ci
        self.mname = mname
        self.module_locks = module_locks
        self.modname = modname
        self.known_classes = known_classes
        self.backrefs = backrefs  # shared per-analysis sink
        self.local_types = {}  # local var -> ClassName
        self.acquired = set()
        self.deferred = 0      # >0 inside lambda / nested def bodies

    def run(self):
        self._stmts(self.ci.methods[self.mname].body, frozenset())
        self.ci.acquires.setdefault(self.mname, set()).update(
            self.acquired)

    # statements ----------------------------------------------------------
    def _stmts(self, stmts, held):
        for s in stmts:
            self._stmt(s, held)

    def _stmt(self, s, held):
        if isinstance(s, (ast.With, ast.AsyncWith)):
            new = set()
            for item in s.items:
                g = self._lock_of(item.context_expr)
                if g is None:
                    self._expr(item.context_expr, held)
                if item.optional_vars is not None:
                    self._expr(item.optional_vars, held)
                if g is not None:
                    for h in held | new:
                        if h != g:
                            self.ci.order_sites.append(
                                (h, g, item.context_expr.lineno))
                    new.add(g)
                    self.acquired.add(g)
            self._stmts(s.body, held | frozenset(new))
        elif isinstance(s, ast.If):
            self._expr(s.test, held)
            self._stmts(s.body, held)
            self._stmts(s.orelse, held)
        elif isinstance(s, (ast.For, ast.AsyncFor)):
            self._expr(s.iter, held)
            self._target(s.target, held)
            self._stmts(s.body, held)
            self._stmts(s.orelse, held)
        elif isinstance(s, ast.While):
            self._expr(s.test, held)
            self._stmts(s.body, held)
            self._stmts(s.orelse, held)
        elif isinstance(s, ast.Try):
            self._stmts(s.body, held)
            for h in s.handlers:
                if h.type is not None:
                    self._expr(h.type, held)
                self._stmts(h.body, held)
            self._stmts(s.orelse, held)
            self._stmts(s.finalbody, held)
        elif isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later, on an unknown thread, without
            # the definition site's locks
            self.deferred += 1
            self._stmts(s.body, frozenset())
            self.deferred -= 1
        elif isinstance(s, ast.ClassDef):
            pass
        elif isinstance(s, ast.Assign):
            self._expr(s.value, held)
            cls = _class_of_value(s.value, self.known_classes)
            for t in s.targets:
                self._target(t, held, value=s.value)
                if cls is not None and isinstance(t, ast.Name):
                    self.local_types[t.id] = cls
        elif isinstance(s, ast.AugAssign):
            self._expr(s.value, held)
            self._target(s.target, held)
        elif isinstance(s, ast.AnnAssign):
            if s.value is not None:
                self._expr(s.value, held)
            self._target(s.target, held)
        elif isinstance(s, ast.Delete):
            for t in s.targets:
                self._target(t, held)
        elif isinstance(s, (ast.Expr, ast.Return)):
            if getattr(s, 'value', None) is not None:
                self._expr(s.value, held)
        elif isinstance(s, ast.Raise):
            if s.exc is not None:
                self._expr(s.exc, held)
            if s.cause is not None:
                self._expr(s.cause, held)
        elif isinstance(s, ast.Assert):
            self._expr(s.test, held)
            if s.msg is not None:
                self._expr(s.msg, held)
        else:
            for child in ast.iter_child_nodes(s):
                if isinstance(child, ast.stmt):
                    self._stmt(child, held)
                elif isinstance(child, ast.expr):
                    self._expr(child, held)

    # write targets -------------------------------------------------------
    def _target(self, t, held, value=None):
        attr = _self_attr(t)
        if attr is not None:
            if not self.ci.lock_attr(attr):
                self._record(attr, t.lineno, 'write', held)
            return
        if isinstance(t, ast.Attribute):
            # write-through one level: ``self._a.b = x`` mutates the
            # object _a points at; also the back-reference typing hook
            # (``self._a.b = self`` types OtherClass.b)
            base = _self_attr(t.value)
            if base is not None:
                if not self.ci.lock_attr(base):
                    self._record(base, t.lineno, 'write', held)
                tcls = self.ci.attr_types.get(base)
                if tcls is not None and value is not None:
                    if _is_self(value):
                        self.backrefs.append((tcls, t.attr,
                                              self.ci.name))
                    else:
                        vcls = _class_of_value(value,
                                               self.known_classes)
                        if vcls is not None:
                            self.backrefs.append((tcls, t.attr, vcls))
                return
            self._expr(t.value, held)
        elif isinstance(t, ast.Subscript):
            base = _self_attr(t.value)
            if base is not None and not self.ci.lock_attr(base):
                self._record(base, t.lineno, 'write', held)
            else:
                self._expr(t.value, held)
            self._expr(t.slice, held)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                self._target(el, held)
        elif isinstance(t, ast.Starred):
            self._target(t.value, held)
        # plain Name targets are locals: nothing to record

    # expressions ---------------------------------------------------------
    def _expr(self, e, held):
        if isinstance(e, ast.Call):
            self._call(e, held)
            return
        if isinstance(e, ast.Lambda):
            self.deferred += 1
            self._expr(e.body, frozenset())
            self.deferred -= 1
            return
        attr = _self_attr(e)
        if attr is not None:
            if self.ci.lock_attr(attr):
                return
            if attr in self.ci.methods:
                # bare bound-method reference (Thread target=, callback
                # registration): the method is enterable from outside,
                # with no locks guaranteed held
                self.ci.calls.append(_Call(('ref', attr), frozenset(),
                                           e.lineno, self.mname))
            else:
                kind = 'write' if isinstance(
                    e.ctx, (ast.Store, ast.Del)) else 'read'
                self._record(attr, e.lineno, kind, held)
            return
        for child in ast.iter_child_nodes(e):
            if isinstance(child, ast.expr):
                self._expr(child, held)
            elif isinstance(child, ast.comprehension):
                self._expr(child.iter, held)
                self._target(child.target, held)
                for cond in child.ifs:
                    self._expr(cond, held)
            elif isinstance(child, ast.keyword):
                self._expr(child.value, held)
            elif isinstance(child, ast.stmt):
                self._stmt(child, held)

    def _call(self, c, held):
        eff = frozenset() if self.deferred else held
        func = c.func
        walked_func = False
        if isinstance(func, ast.Attribute):
            recv = _self_attr(func)
            base = _self_attr(func.value)
            if recv is not None:
                # self.X(...): a method call, a lock-method call, or a
                # callable field
                if recv in self.ci.methods:
                    spec = ('ref', recv) if self.deferred \
                        else ('self', recv)
                    self.ci.calls.append(_Call(spec, eff, c.lineno,
                                               self.mname))
                elif not self.ci.lock_attr(recv):
                    self._record(recv, c.lineno, 'read', held)
                walked_func = True
            elif base is not None:
                # self.X.meth(...): container mutation, or a call into
                # a typed attribute's class (resolved at graph time —
                # back-reference typings land after the walk)
                if not self.ci.lock_attr(base):
                    kind = 'write' if func.attr in _MUTATORS else 'read'
                    self._record(base, c.lineno, kind, held)
                    self.ci.calls.append(_Call(
                        ('attr', base, func.attr), eff, c.lineno,
                        self.mname))
                walked_func = True
            elif isinstance(func.value, ast.Name):
                tcls = self.local_types.get(func.value.id)
                if tcls is not None:
                    self.ci.calls.append(_Call(
                        ('class', tcls, func.attr), eff, c.lineno,
                        self.mname))
            if not walked_func:
                self._expr(func.value, held)
        elif isinstance(func, ast.Name):
            pass  # free function call; args still walked below
        else:
            self._expr(func, held)
        for a in c.args:
            if isinstance(a, ast.Starred):
                self._expr(a.value, held)
            else:
                self._expr(a, held)
        for kw in c.keywords:
            self._expr(kw.value, held)

    # bookkeeping ---------------------------------------------------------
    def _lock_of(self, ctx):
        attr = _self_attr(ctx)
        if attr is not None and self.ci.lock_attr(attr):
            return ('class', self.ci.name, self.ci.groups.find(attr))
        if isinstance(ctx, ast.Name) and ctx.id in self.module_locks:
            return ('module', self.modname, ctx.id)
        return None

    def _record(self, field, lineno, kind, held):
        self.ci.accesses.append(_Access(field, self.mname, lineno,
                                        kind, frozenset(held)))


# -- reachability / caller-holds ------------------------------------------
def _closure(edges, roots):
    seen = set(roots)
    stack = list(roots)
    while stack:
        n = stack.pop()
        for m in edges.get(n, ()):
            if m not in seen:
                seen.add(m)
                stack.append(m)
    return seen


def _self_edges(ci, include_refs=True):
    edges = {}
    for call in ci.calls:
        if call.spec[0] == 'self' or (include_refs
                                      and call.spec[0] == 'ref'):
            edges.setdefault(call.method, set()).add(call.spec[1])
    return edges


def _escaping(ci):
    """Methods referenced without being called (Thread targets,
    callbacks): enterable from outside, lock-free."""
    return {c.spec[1] for c in ci.calls if c.spec[0] == 'ref'} \
        | ci.thread_roots


def _exempt_methods(ci):
    """__init__ plus private helpers reachable ONLY from __init__ and
    never escaping: construction precedes every thread."""
    edges = _self_edges(ci)
    entries = {m for m in ci.methods
               if m != '__init__'
               and (not m.startswith('_') or m.startswith('__'))}
    entries |= (_escaping(ci) & set(ci.methods))
    non_exempt = _closure(edges, entries)
    init_only = _closure(edges, {'__init__'}) - non_exempt
    return ({'__init__'} | init_only) & set(ci.methods)


def _inherited_held(ci):
    """Caller-holds propagation for private helpers: the intersection
    of held sets over every intra-class call site.  Escaping and
    public methods inherit nothing — they are entered lock-free."""
    sites = {}
    for call in ci.calls:
        if call.spec[0] == 'self':
            sites.setdefault(call.spec[1], []).append(call)
    escaping = _escaping(ci)
    inherited = {m: frozenset() for m in ci.methods}
    for _ in range(len(ci.methods) + 1):
        changed = False
        for m in ci.methods:
            if (not m.startswith('_') or m.startswith('__')
                    or m in escaping or m not in sites):
                continue
            acc = None
            for call in sites[m]:
                h = call.held | inherited.get(call.method, frozenset())
                acc = h if acc is None else (acc & h)
            acc = acc if acc is not None else frozenset()
            if acc != inherited[m]:
                inherited[m] = acc
                changed = True
        if not changed:
            break
    return inherited


# -- guarded-by verdicts ---------------------------------------------------
def _group_label(ci, group):
    members = [m for m in ci.groups.members(group)
               if not m.startswith('<local:')]
    return '/'.join(members) if members else str(group)


def _guard_label(ci, guard):
    if guard[0] == 'class':
        return _group_label(ci, guard[2])
    return '%s.%s' % (guard[1], guard[2])


def _class_findings(ci, report):
    if not any(not g.startswith('<local:') for g in ci.groups.names()):
        return
    report.classes += 1
    exempt = _exempt_methods(ci)
    inherited = _inherited_held(ci)
    worker_reachable = _closure(_self_edges(ci), _escaping(ci))

    per_field = {}
    for a in ci.accesses:
        if a.method in exempt:
            continue
        held = a.held | inherited.get(a.method, frozenset())
        per_field.setdefault(a.field, []).append(a._replace(held=held))

    for field, accesses in sorted(per_field.items()):
        ann = ci.annotations.get(field)
        if ann is not None and ann[0] == 'unguarded-ok':
            reason = ann[1].strip()
            if not reason:
                report.findings.append(Finding(
                    'bad-waiver', ci.path, ann[2], ci.name, field,
                    None, None,
                    "%s.%s: unguarded-ok waiver with an EMPTY reason "
                    "— a waiver must say why the unguarded access is "
                    "benign" % (ci.name, field)))
            else:
                for f in _field_findings(ci, field, accesses,
                                         worker_reachable, None):
                    report.waived.append((f, reason))
            continue
        declared = None
        if ann is not None and ann[0] == 'guarded_by':
            lock_attr = ann[1].strip()
            if not ci.lock_attr(lock_attr):
                report.findings.append(Finding(
                    'bad-annotation', ci.path, ann[2], ci.name, field,
                    lock_attr, None,
                    "%s.%s: guarded_by(%s) names no lock attribute of "
                    "the class" % (ci.name, field, lock_attr)))
                continue
            declared = ('class', ci.name, ci.groups.find(lock_attr))
        found = _field_findings(ci, field, accesses, worker_reachable,
                                declared)
        report.findings.extend(found)
        guard = declared if declared is not None \
            else _consistent_guard(accesses)
        if guard is not None and not found:
            report.guarded_by['%s.%s' % (ci.name, field)] = \
                _guard_label(ci, guard)


def _consistent_guard(accesses):
    common = None
    for a in accesses:
        common = a.held if common is None else (common & a.held)
        if not common:
            return None
    return sorted(common)[0] if common else None


def _field_findings(ci, field, accesses, worker_reachable, declared):
    """The core lockset rule for one field."""
    if declared is None:
        writes = [a for a in accesses if a.kind == 'write']
        if not writes:
            return []  # read-only post-init: nothing to race with
        # candidate guards: locks held at >=1 access; pick the one
        # covering the most accesses (ties prefer write coverage)
        cover = {}
        for a in accesses:
            for g in a.held:
                cov = cover.setdefault(g, [0, 0])
                cov[0] += 1
                cov[1] += a.kind == 'write'
        if not cover:
            return []  # never lock-associated: no lockset signal
        # the best-covering candidate (ties prefer write coverage):
        # a write under it OR a read under it both make the field
        # lock-associated — a guarded-reads/unguarded-writer split is
        # the classic lost-update race, not a pass
        guard = max(sorted(cover), key=lambda g: tuple(cover[g]))
    else:
        guard = declared
    out = []
    label = _guard_label(ci, guard)
    hint = label.split('/')[0]
    for a in accesses:
        if guard in a.held:
            continue
        kind = ('unguarded-write' if a.kind == 'write'
                else 'unguarded-read')
        if a.method in worker_reachable:
            via = 'thread entrypoint(s) %s' % ','.join(
                sorted(ci.thread_roots) or ['<escaping ref>'])
        else:
            via = ('caller threads (public surface of a lock-owning '
                   'class)')
        out.append(Finding(
            kind, ci.path, a.lineno, ci.name, field, label, a.method,
            "%s.%s %s in %s() without %s (%s guards it elsewhere; "
            "thread-reachable via %s).  Fix the access, or annotate "
            "the field: '# lock: guarded_by(%s)' to enforce, "
            "'# lock: unguarded-ok(<reason>)' to waive"
            % (ci.name, field,
               'written' if a.kind == 'write' else 'read',
               a.method, label, label, via, hint)))
    return out


# -- lock-order graph ------------------------------------------------------
def _key_name(gkey, classes):
    if gkey[0] == 'class':
        ci = classes.get(gkey[1])
        label = _group_label(ci, gkey[2]) if ci is not None \
            else str(gkey[2])
        return '%s.%s' % (gkey[1], label.split('/')[0])
    return '%s.%s' % (gkey[1], gkey[2])


def _order_graph(classes, report):
    """Edges from lexical nesting + one-level interprocedural calls."""
    trans = {}  # (class, method) -> set(acquired group keys)
    for cname, ci in classes.items():
        edges = _self_edges(ci, include_refs=False)
        for m in ci.methods:
            acq = set()
            for r in _closure(edges, {m}):
                acq.update(ci.acquires.get(r, ()))
            trans[(cname, m)] = acq

    def add_edge(src, dst, path, lineno):
        if src == dst:
            return
        report.order_edges.setdefault(
            (_key_name(src, classes), _key_name(dst, classes)),
            []).append((path, lineno))

    for cname, ci in classes.items():
        for src, dst, lineno in ci.order_sites:
            add_edge(src, dst, ci.path, lineno)
        for call in ci.calls:
            if not call.held:
                continue
            spec = call.spec
            if spec[0] == 'self':
                acq = trans.get((cname, spec[1]), set())
            elif spec[0] == 'attr':
                tcls = ci.attr_types.get(spec[1])
                acq = trans.get((tcls, spec[2]), set()) \
                    if tcls is not None else set()
            elif spec[0] == 'class':
                acq = trans.get((spec[1], spec[2]), set())
            else:
                continue
            for g in acq:
                for h in call.held:
                    add_edge(h, g, ci.path, call.lineno)


def _order_cycles(report):
    """Tarjan SCC over the order graph; each nontrivial SCC (or
    self-loop) is one potential-deadlock finding."""
    graph = {}
    for (src, dst) in report.order_edges:
        graph.setdefault(src, set()).add(dst)
        graph.setdefault(dst, set())
    index, low, on, stack, sccs = {}, {}, set(), [], []
    counter = [0]

    def strong(v):
        work = [(v, iter(sorted(graph[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)

    for v in sorted(graph):
        if v not in index:
            strong(v)

    for scc in sccs:
        if not (len(scc) > 1 or scc[0] in graph.get(scc[0], ())):
            continue
        nodes = sorted(scc)
        sites, path, lineno = [], None, 0
        for (src, dst), locs in sorted(report.order_edges.items()):
            if src in scc and dst in scc:
                sites.append('%s->%s at %s:%d'
                             % (src, dst, locs[0][0], locs[0][1]))
                if path is None:
                    path, lineno = locs[0]
        report.findings.append(Finding(
            'lock-order-cycle', path or '<graph>', lineno, None, None,
            ' <-> '.join(nodes), None,
            "lock acquisition order cycle (potential deadlock) "
            "between {%s}: %s — pick one global order and restructure "
            "the inner acquisition" % (', '.join(nodes),
                                       '; '.join(sites))))


# -- module driver ---------------------------------------------------------
def _annotations(src):
    """{lineno: (form, arg)} from REAL comment tokens only — a
    docstring or message string that merely mentions the annotation
    grammar must not register as one (tokenize, not a line regex)."""
    import io
    import tokenize
    out = {}
    try:
        for tok in tokenize.generate_tokens(io.StringIO(src).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _ANNOT_RE.search(tok.string)
            if m:
                out[tok.start[0]] = (m.group(1), m.group(2))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        pass  # unparsable files already report via ast.parse
    return out


def _module_locks(tree):
    out = set()
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and _lock_ctor_kind(stmt.value):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
    return out


def analyze_source(src, path='<string>', report=None):
    """Analyze one module's source; returns (appends into) a Report."""
    return _analyze_modules([(path, src)], report=report)


def _analyze_modules(modules, report=None):
    report = report or Report()
    # back-reference typings discovered while walking (class, attr,
    # type) — a per-analysis local so concurrent analyses (the
    # watchdog's lazy package sweep on a warmup thread vs a test's
    # analyze_source) cannot corrupt each other
    backrefs = []
    parsed, known_classes = [], set()
    for path, src in modules:
        try:
            tree = ast.parse(src)
        except SyntaxError as e:
            report.findings.append(Finding(
                'bad-annotation', path, e.lineno or 0, None, None,
                None, None, 'file does not parse: %s' % e))
            continue
        parsed.append((path, src, tree))
        for node in tree.body:
            if isinstance(node, ast.ClassDef):
                known_classes.add(node.name)

    classes = {}  # ClassName -> _ClassInfo (first definition wins)
    per_module = []
    for path, src, tree in parsed:
        modname = os.path.splitext(os.path.basename(path))[0]
        mlocks = _module_locks(tree)
        annots = _annotations(src)
        mod_classes = {}
        for node in tree.body:
            if not isinstance(node, ast.ClassDef):
                continue
            ci = _ClassInfo(node.name, node, path)
            _discover_locks(ci, known_classes)
            mod_classes[node.name] = ci
            classes.setdefault(node.name, ci)
        _discover_thread_targets(tree, path, mod_classes, report)
        per_module.append((path, modname, mlocks, annots, mod_classes))

    for path, modname, mlocks, annots, mod_classes in per_module:
        for ci in mod_classes.values():
            for mname in ci.methods:
                _MethodWalker(ci, mname, mlocks, modname,
                              known_classes, backrefs).run()

    # back-reference typings (A.__init__ typing B's attr) land after
    # every walk; ('attr', ...) call specs resolve lazily against them
    for tcls, attr, vcls in backrefs:
        ci = classes.get(tcls)
        if ci is not None:
            ci.attr_types.setdefault(attr, vcls)

    # attach annotations to the fields assigned on their lines (inline
    # comment) or on the line right below (standalone comment above
    # the assignment — the style long reasons need at 79 columns)
    for path, modname, mlocks, annots, mod_classes in per_module:
        claimed = set()
        for ci in mod_classes.values():
            for lineno, (form, arg) in annots.items():
                field = ci.field_lines.get(lineno)
                if field is None:
                    field = ci.field_lines.get(lineno + 1)
                if field is not None:
                    ci.annotations[field] = (form, arg, lineno)
                    claimed.add(lineno)
        for lineno, (form, _arg) in sorted(annots.items()):
            if lineno not in claimed:
                report.findings.append(Finding(
                    'bad-annotation', path, lineno, None, None, None,
                    None,
                    "'# lock: %s(...)' annotation is not attached to "
                    "a 'self.<field> = ...' assignment on its line"
                    % form))

    for path, modname, mlocks, annots, mod_classes in per_module:
        for ci in mod_classes.values():
            _class_findings(ci, report)
    _order_graph(classes, report)
    _order_cycles(report)
    return report


def package_root():
    """The paddle_tpu_torch package directory this module ships in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def analyze_paths(paths, rel_to=None):
    modules = []
    for p in paths:
        with open(p) as f:
            src = f.read()
        rel = os.path.relpath(p, rel_to) if rel_to else p
        modules.append((rel, src))
    return _analyze_modules(modules)


def analyze_package(root=None):
    """Sweep every .py under the package (default: paddle_tpu_torch)."""
    root = root or package_root()
    paths = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != '__pycache__']
        for fn in sorted(filenames):
            if fn.endswith('.py'):
                paths.append(os.path.join(dirpath, fn))
    return analyze_paths(sorted(paths), rel_to=os.path.dirname(root))
