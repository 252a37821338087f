"""Op registry.

Reference parity: paddle_tpu/core/registry.py (paddle/framework/
op_registry.h).  Each op type maps to one compute function

    def compute(ctx, ins, attrs) -> {slot: [torch.Tensor, ...]}

where ``ins`` is {slot: [tensors]} and ``ctx`` is the executor's
ExecutionContext (device, per-op random generator).  The function runs
eagerly on the tensors' device; a kernel is reached through its wrapper,
which dispatches on that device.

``op_traits`` classifies an op type for the pass pipeline (transpiler/)
without fetching it for execution: registered, random, ``needs_env`` (a
control-flow op that interprets a sub-block over the live environment),
its AMP class (white, black or grey, the reference's lists verbatim) and
its cost class ('mac' or 'bytes', read by transpiler/cost_model.py).
``op_signature`` recovers each op's declared-slot contract from its
compute function's source, as the reference does by AST introspection;
the IR verifier (transpiler/verify.py) holds every OpDesc to it.
"""
import ast
import collections
import inspect
import textwrap

__all__ = ['OpImpl', 'register_op', 'get_op_impl', 'has_op', 'op_traits',
           'op_signature', 'registered_ops', 'amp_class', 'AMP_WHITE',
           'AMP_BLACK', 'COST_MAC', 'cost_class']

_OP_REGISTRY = {}

# ---------------------------------------------------------------------------
# AMP (automatic mixed precision) op classification, read by the
# transpiler/amp.py cast-insertion pass through op_traits().  The lists
# are the reference's (paddle_tpu/core/registry.py), names of op types the
# port does not register yet included, so an op keeps its class the day
# it is ported.
#
# AMP_WHITE: matmul-shaped ops whose products land on the tensor cores;
# under PADDLE_TPU_TORCH_AMP they run in bf16/f16.
#
# AMP_BLACK: ops that stay f32: losses and softmaxes, normalization
# statistics, wide accumulations, range-sensitive elementwise math,
# metrics, the optimizer updates (f32 master weights) and the AMP ops.
#
# Everything else is GREY: precision follows the inputs.
AMP_WHITE = frozenset({
    'matmul', 'mul',
    'conv2d', 'conv2d_transpose', 'conv3d', 'conv3d_transpose',
    'sequence_conv', 'conv_shift', 'row_conv',
    'bilinear_tensor_product', 'flash_attention', 'paged_attention',
    'chunked_prefill_attention',
    'lstm', 'lstm_unit', 'gru', 'gru_unit',
    # fused vocab-head CE ops: dominated by the [N,D]x[D,V] matmul and
    # internally f32-safe (f32 logits and softmax state), so their INPUTS
    # lower; their loss outputs are always f32 (amp.py
    # WHITE_F32_OUTPUT_OPS)
    'fused_linear_softmax_ce', 'vocab_parallel_ce',
})

AMP_BLACK = frozenset({
    # softmax family + losses (dynamic range / reductions over logits)
    'softmax', 'sequence_softmax',
    'cross_entropy', 'softmax_with_cross_entropy',
    'sigmoid_cross_entropy_with_logits', 'square_error_cost',
    'smooth_l1', 'smooth_l1_loss', 'hinge_loss', 'huber_loss',
    'log_loss', 'margin_rank_loss', 'modified_huber_loss', 'rank_loss',
    'warpctc', 'nce', 'linear_chain_crf', 'crf_decoding',
    # normalization / statistics
    'batch_norm', 'layer_norm', 'norm', 'lrn', 'l1_norm',
    'squared_l2_norm', 'squared_l2_distance', 'cos_sim', 'clip_by_norm',
    # wide accumulations
    'sum', 'mean', 'reduce_sum', 'reduce_mean', 'reduce_prod',
    # range-sensitive elementwise math
    'exp', 'log', 'pow', 'square',
    # metrics
    'accuracy', 'auc', 'precision_recall', 'positive_negative_pair',
    'chunk_eval', 'edit_distance', 'detection_output',
    # optimizer updates apply to the f32 masters
    'sgd', 'momentum', 'adam', 'adamax', 'adagrad', 'decayed_adagrad',
    'adadelta', 'rmsprop', 'ftrl', 'proximal_gd', 'proximal_adagrad',
    # grad machinery + the AMP ops themselves
    'sparse_grad_assemble', 'check_finite_and_unscale',
    'update_loss_scale',
})


def amp_class(type):
    """'white' | 'black' | 'grey' AMP classification for an op type.
    Unregistered/unknown types are grey (the safe default: grey can
    never lower a value's precision on its own)."""
    if type in AMP_WHITE:
        return 'white'
    if type in AMP_BLACK:
        return 'black'
    return 'grey'


# ---------------------------------------------------------------------------
# Cost classification, read by transpiler/cost_model.py and reported by
# op_traits().cost.  COST_MAC: ops whose cost is multiply-accumulates on
# the tensor cores, each with a closed-form MAC formula in
# cost_model.MAC_FORMULAS.  It is the AMP white set, as the reference
# sets it: "the products land on the matrix units" is one property, so a
# matmul-shaped op registered white without a formula fails the coverage
# sweep instead of costing 0.  Every other op is 'bytes': its cost is the
# memory it moves (inputs read, outputs written), its FLOPs read 0.
COST_MAC = frozenset(AMP_WHITE)


def cost_class(type):
    """'mac' | 'bytes' cost class of an op type (see COST_MAC)."""
    return 'mac' if type in COST_MAC else 'bytes'


OpTraits = collections.namedtuple(
    'OpTraits', ['registered', 'stateful_rng', 'needs_env', 'amp', 'cost'])


class OpImpl(object):
    def __init__(self, type, compute, stateful_rng=False, needs_env=False):
        self.type = type
        self.compute = compute
        # ops that draw random numbers (uniform_random): the executor
        # hands them a generator keyed by the op's position
        self.stateful_rng = stateful_rng
        # control-flow ops that interpret a sub-block: the executor hands
        # them the live environment as ins['__env__'] and applies the
        # dict they return as {'__env_update__': [dict]}
        self.needs_env = needs_env


def register_op(type, stateful_rng=False, needs_env=False):
    def deco(fn):
        if type in _OP_REGISTRY:
            raise ValueError("op %r already registered" % type)
        _OP_REGISTRY[type] = OpImpl(type, fn, stateful_rng, needs_env)
        return fn

    return deco


# op types the reference registers whose port waits for a named item
_LATER_OPS = {
    'parallel_do': 'item 10 (distribution)',
    'get_places': 'item 10 (distribution)',
}


def get_op_impl(type):
    impl = _OP_REGISTRY.get(type)
    if impl is None:
        raise NotImplementedError(
            "op %r has no implementation in paddle_tpu_torch yet; the port "
            "brings ops slice by slice (ROADMAP.md, Queue 1%s)"
            % (type, ', ' + _LATER_OPS[type] if type in _LATER_OPS else ''))
    return impl


def has_op(type):
    return type in _OP_REGISTRY


def op_traits(type):
    """OpTraits(registered, stateful_rng, needs_env, amp, cost) for an
    op type; ``amp`` is 'white' | 'black' | 'grey' (see AMP_WHITE /
    AMP_BLACK), ``cost`` 'mac' | 'bytes' (see COST_MAC)."""
    impl = _OP_REGISTRY.get(type)
    if impl is None:
        return OpTraits(False, False, False, amp_class(type),
                        cost_class(type))
    return OpTraits(True, impl.stateful_rng, impl.needs_env,
                    amp_class(type), cost_class(type))


# ---------------------------------------------------------------------------
# Static op signatures (OpProto parity, recovered by introspection).
#
# A signature dimension is *closed* when the AST walk accounted for every
# use of the corresponding parameter (`ins` / `attrs` / the return value);
# it is *open* when the function does something the walk cannot name (e.g.
# iterates ins.items(), builds slot names dynamically, returns a dict
# assembled elsewhere).  Open dimensions are simply not checkable — the
# verifier skips them instead of guessing.

OpSignature = collections.namedtuple('OpSignature', [
    'in_slots',        # frozenset: input slot names the fn can read
    'in_open',         # True -> in_slots is incomplete, don't enforce
    'out_slots',       # frozenset: output slot names the fn can return
    'out_open',        # True -> out_slots is incomplete, don't enforce
    'attr_keys',       # frozenset: every attr key the fn reads
    'required_attrs',  # frozenset: keys read unconditionally via attrs[k]
])

_OPEN_SIGNATURE = OpSignature(frozenset(), True, frozenset(), True,
                              frozenset(), frozenset())
_SIG_CACHE = {}

# dict methods whose use keeps the slot set knowable (.get with a literal
# key) vs. ones that make it open (whole-dict iteration/copy)
_OPEN_DICT_METHODS = ('items', 'values', 'keys', 'pop', 'update', 'copy',
                      'setdefault')


class _SigVisitor(ast.NodeVisitor):
    """Collect literal-keyed accesses of one dict-shaped parameter.

    Tracks whether each access is control-flow-conditional (inside
    If/IfExp/Try/loop bodies, boolop tails, or nested defs/lambdas) so
    ``attrs['k']`` counts as *required* only when it runs on every call.
    """

    def __init__(self, param):
        self.param = param
        self.keys = set()
        self.required = set()     # unconditional [k] subscripts
        self.guarded = set()      # keys seen via .get()/`in` (optional)
        self.open = False
        self._covered = set()     # id()s of Name nodes already explained
        self._cond = 0

    # -- helpers -----------------------------------------------------------
    def _is_param(self, node):
        return isinstance(node, ast.Name) and node.id == self.param

    def _const_str(self, node):
        return node.value if (isinstance(node, ast.Constant)
                              and isinstance(node.value, str)) else None

    # -- conditional-context scaffolding -----------------------------------
    def _visit_cond(self, node):
        self._cond += 1
        try:
            self.generic_visit(node)
        finally:
            self._cond -= 1

    def visit_IfExp(self, node):
        self.visit(node.test)
        self._cond += 1
        try:
            self.visit(node.body)
            self.visit(node.orelse)
        finally:
            self._cond -= 1

    def visit_If(self, node):
        self.visit(node.test)
        self._cond += 1
        try:
            for n in node.body + node.orelse:
                self.visit(n)
        finally:
            self._cond -= 1

    def visit_Try(self, node):
        self._visit_cond(node)

    def visit_While(self, node):
        self._visit_cond(node)

    def visit_For(self, node):
        self._visit_cond(node)

    def visit_BoolOp(self, node):
        self.visit(node.values[0])
        self._cond += 1
        try:
            for v in node.values[1:]:
                self.visit(v)
        finally:
            self._cond -= 1

    def visit_FunctionDef(self, node):
        self._visit_cond(node)  # inner defs may never run

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node):
        self._visit_cond(node)

    # -- the accesses ------------------------------------------------------
    def visit_Subscript(self, node):
        if self._is_param(node.value):
            self._covered.add(id(node.value))
            key = self._const_str(node.slice)
            if key is None:
                self.open = True
            else:
                self.keys.add(key)
                if self._cond == 0:
                    self.required.add(key)
        self.generic_visit(node)

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute) and self._is_param(func.value):
            self._covered.add(id(func.value))
            if func.attr == 'get':
                key = (self._const_str(node.args[0])
                       if node.args else None)
                if key is None:
                    self.open = True
                else:
                    self.keys.add(key)
                    self.guarded.add(key)
            elif func.attr in _OPEN_DICT_METHODS:
                self.open = True
        elif isinstance(func, ast.Name) and func.id == 'first' and \
                any(self._is_param(a) for a in node.args):
            # ops/common.py first(ins, 'X') — the dominant idiom
            for a in node.args:
                if self._is_param(a):
                    self._covered.add(id(a))
            key = next((self._const_str(a) for a in node.args
                        if self._const_str(a) is not None), None)
            if key is None:
                self.open = True
            else:
                self.keys.add(key)
        self.generic_visit(node)

    def visit_Compare(self, node):
        # `'k' in attrs` proves the fn handles absence -> optional
        if len(node.ops) == 1 and isinstance(node.ops[0],
                                             (ast.In, ast.NotIn)) and \
                self._is_param(node.comparators[0]):
            self._covered.add(id(node.comparators[0]))
            key = self._const_str(node.left)
            if key is not None:
                self.guarded.add(key)
            else:
                self.open = True
        self.generic_visit(node)

    def visit_Name(self, node):
        if node.id == self.param and id(node) not in self._covered:
            # the param escapes (passed whole to a helper, aliased,
            # len()'d...): the walk can no longer claim completeness
            self.open = True


def _return_slots(fn_node):
    """Output slot names derivable from the function's return statements.
    Returns (slots, open)."""
    slots, open_ = set(), False

    def analyze(value):
        nonlocal open_
        if value is None or (isinstance(value, ast.Constant)
                             and value.value is None):
            return
        if isinstance(value, ast.Call) and \
                isinstance(value.func, ast.Name) and \
                value.func.id == 'out':
            slots.add('Out')  # ops/common.py out(x) -> {'Out': [x]}
            return
        if isinstance(value, ast.Dict):
            for k in value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    if k.value != '__env_update__':
                        slots.add(k.value)
                else:
                    open_ = True
            return
        if isinstance(value, ast.IfExp):
            analyze(value.body)
            analyze(value.orelse)
            return
        open_ = True

    for node in ast.walk(fn_node):
        if isinstance(node, ast.Return):
            analyze(node.value)
    return slots, open_


_MODULE_FN_INDEX = {}  # filename -> [FunctionDef]


def _find_fn_node(compute):
    """The FunctionDef AST node of a compute function, via a per-module
    parse (inspect.getsource per function re-tokenizes the file each
    time — across ~30 op types that is the whole cold-verify budget)."""
    code = getattr(compute, '__code__', None)
    if code is None:
        return None
    fname = code.co_filename
    nodes = _MODULE_FN_INDEX.get(fname)
    if nodes is None:
        try:
            with open(fname) as f:
                tree = ast.parse(f.read())
        except (OSError, SyntaxError, ValueError):
            nodes = []
        else:
            nodes = [n for n in ast.walk(tree)
                     if isinstance(n, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))]
        _MODULE_FN_INDEX[fname] = nodes
    want = code.co_firstlineno
    for n in nodes:
        lines = [n.lineno] + [d.lineno for d in n.decorator_list]
        if want in lines and n.name == compute.__name__:
            return n
    return None


def _introspect_signature(compute):
    fn = _find_fn_node(compute)
    if fn is None:
        try:
            src = textwrap.dedent(inspect.getsource(compute))
            tree = ast.parse(src)
        except (OSError, TypeError, SyntaxError, IndentationError):
            return _OPEN_SIGNATURE
        fn = next((n for n in tree.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))), None)
    if fn is None or len(fn.args.args) < 3:
        return _OPEN_SIGNATURE
    ins_param = fn.args.args[1].arg
    attrs_param = fn.args.args[2].arg

    ins_v = _SigVisitor(ins_param)
    attrs_v = _SigVisitor(attrs_param)
    for stmt in fn.body:
        ins_v.visit(stmt)
        attrs_v.visit(stmt)
    out_slots, out_open = _return_slots(fn)
    return OpSignature(
        in_slots=frozenset(ins_v.keys - {'__env__'}),
        in_open=ins_v.open,
        out_slots=frozenset(out_slots),
        out_open=out_open,
        attr_keys=frozenset(attrs_v.keys),
        required_attrs=frozenset(attrs_v.required - attrs_v.guarded),
    )


def op_signature(type):
    """OpSignature for a registered op type (None when unregistered).
    Introspected once per process and cached — the verifier calls this
    for every op of every plan build."""
    impl = _OP_REGISTRY.get(type)
    if impl is None:
        return None
    sig = _SIG_CACHE.get(type)
    if sig is None:
        sig = _introspect_signature(impl.compute)
        _SIG_CACHE[type] = sig
    return sig


def registered_ops():
    return sorted(_OP_REGISTRY)
