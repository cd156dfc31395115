"""AST pass for host syncs and reproducibility hazards on the step path
(codes RT101, RT102, RT104, RT105).

Port of ``repro.analysis.retrace``.  The reference scopes RT101/RT104 to
functions under ``jax.jit``; eager PyTorch has no ``jit``, so the scope is
a declared **hot-path set**, :data:`HOT_PATHS`: one ``path::qualname`` for
each port function whose reference counterpart is jit-compiled
(:data:`JIT_COUNTERPARTS`), plus the per-step paths the reference jits
through ``shard_map`` or runs once a service tick (:data:`STEP_PATHS`).
A function nested in a hot-path function is on the hot path too.

* **RT101**: a host read in a hot-path function: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float()``/``int()``/``bool()``
  of a tensor parameter or local, ``np.asarray``/``np.array`` of one, and
  ``torch.cuda.synchronize()`` (or an event's or stream's
  ``.synchronize()``).  Each waits for the card, so the host stops
  queueing the step's launches;
* **RT102**: ``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace``
  applied inside a function body (a fresh compile per call), including a
  decorated def nested in a function; ``__init__`` is sanctioned;
* **RT104**: in a hot-path function, ``time.*``, ``random.*`` and
  ``np.random.*`` module functions, and a torch draw (``rand*``,
  ``randn*``, ``randint``, ``randperm``, ``normal``, ``normal_``,
  ``uniform_``, ``bernoulli``, ``multinomial``) without ``generator=``;
* **RT105**: a device ``synchronize()`` outside a Tracer span anywhere in
  a module (``obs/`` implements the spans and is exempt); use ``sp.sync``.

A tensor is a parameter annotated with ``Tensor``, or a local bound from a
``torch.*`` call, a tensor's method, an index, an attribute, arithmetic, a
comparison or iteration over one, or from a call of a module-level hot-path
function (whose results, e.g. ``tsne_step``'s ``StepStats``, hold
tensors).  The inference is flow-insensitive and follows no other call.

The pass is source -> findings (:func:`scan_source`); file iteration,
pragma application and baselines live in :mod:`repro_torch.analysis.cli`.
"""
from __future__ import annotations

import ast
from collections.abc import Iterable

from repro_torch.analysis.findings import Finding

PORT = "src/repro_torch"

# the port's counterparts of the reference's jit-compiled functions, in
# the modules the port mirrors path for path (tests pin this set to an AST
# walk of the reference, through RENAMED):
JIT_COUNTERPARTS = frozenset(f"{PORT}/{p}" for p in (
    "core/bsp.py::binary_search_perplexity_plain",
    "core/fft_repulsion.py::fft_repulsion",
    "core/knn.py::knn",
    "core/knn.py::knn_query",
    "core/morton.py::morton_encode",
    "core/naive.py::naive_attractive",
    "core/naive.py::naive_build_and_summarize",
    "core/quadtree.py::build_quadtree",
    "core/repulsive.py::bh_repulsion_sorted",
    "core/tsne.py::tsne_step",
    "embed/transform.py::transform_step",
    "launch/tsne_run.py::dist_step",
    "neighbors/_candidates.py::seed_graph",
    "neighbors/nn_descent.py::nn_descent_knn",
    "neighbors/rp_forest.py::build_forest_index",
    "neighbors/rp_forest.py::build_tree",
    "neighbors/rp_forest.py::forest_query",
    "neighbors/rp_forest.py::leaf_topk",
    "neighbors/rp_forest.py::rp_forest_knn",
))
# reference qualname -> the port's, where the port renamed a jitted function
RENAMED = {
    "core/bsp.py::_binary_search_perplexity_xla": "core/bsp.py::binary_search_perplexity_plain",
    "launch/tsne_run.py::_dist_step": "launch/tsne_run.py::dist_step",
    "neighbors/rp_forest.py::_build_tree": "neighbors/rp_forest.py::build_tree",
    "neighbors/rp_forest.py::_leaf_topk": "neighbors/rp_forest.py::leaf_topk",
}
# per-step paths: the sharded gradient and update the reference compiles
# through shard_map, the descent loop that queues every step of a fit, the
# service's tick (one transform_step for every lane), the LM engine's
# tick (one decode_step for every slot) and the LM train step (the
# reference jits it in Trainer.__init__; its nested train_step runs the
# forward, the backward and the optimizer update of every step)
STEP_PATHS = frozenset(f"{PORT}/{p}" for p in (
    "core/tsne.py::descend",
    "core/distributed.py::local_bh_gradient",
    "core/distributed.py::distributed_bh_gradient",
    "core/distributed.py::gd_update_sharded",
    "embed/service.py::EmbeddingService.step",
    "serve/engine.py::ServeEngine.step",
    "train/step.py::make_train_step",
))
HOT_PATHS = JIT_COUNTERPARTS | STEP_PATHS

# module paths exempt from RT105 (they implement the tracer machinery)
EXEMPT_PATH_PARTS = ("obs",)

_HOST_CASTS = {"float", "int", "bool"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_NP_SYNC_FUNCS = {"asarray", "array"}
_TIME_FUNCS = {"time", "perf_counter", "monotonic", "process_time",
               "thread_time", "clock_gettime", "time_ns", "perf_counter_ns",
               "monotonic_ns"}
_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
                "randint_like", "randperm", "normal", "bernoulli",
                "multinomial"}
_TENSOR_DRAWS = {"normal_", "uniform_", "bernoulli", "bernoulli_",
                 "multinomial"}
_COMPILERS = {("compile",), ("jit", "script"), ("jit", "trace")}
# torch.* callables that return no tensor, and submodules whose calls don't
_TORCH_NON_TENSOR = {"device", "Generator", "Size", "dtype", "is_tensor",
                     "numel", "get_default_dtype", "finfo", "iinfo"}
_TORCH_NON_TENSOR_MODS = {"cuda", "backends", "distributed", "profiler",
                          "autograd", "jit", "nn", "utils"}
# tensor methods and attributes that give a host value, not a tensor
_NON_TENSOR_METHODS = {"item", "tolist", "numpy", "size", "dim", "numel",
                       "nelement", "data_ptr", "element_size", "stride",
                       "is_contiguous", "get_device", "untyped_storage"}
# attributes of a tensor that are host values
_HOST_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
               "requires_grad", "is_sparse", "names"}


def _chain(node: ast.expr) -> list[str] | None:
    """``a.b.c`` -> ["a", "b", "c"]; None if not a plain dotted name."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return [node.id, *reversed(parts)]
    return None


def _is_cpu_call(node: ast.expr) -> bool:
    return isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
        and node.func.attr == "cpu"


class _Aliases:
    """Import names seen anywhere in the module, resolved to what we track."""

    def __init__(self, tree: ast.Module):
        self.torch: set[str] = set()        # `import torch [as t]`
        self.np: set[str] = set()           # `import numpy [as np]`
        self.time_mod: set[str] = set()
        self.time_fn: set[str] = set()      # `from time import perf_counter`
        self.random_mod: set[str] = set()
        self.sync_fn: set[str] = set()      # `from torch.cuda import synchronize`
        self.compile_fn: set[str] = set()   # `from torch import compile`
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname and "." in a.name:
                        continue          # binds the submodule, not its root
                    root = a.name.split(".")[0]
                    tgt = a.asname or root
                    if root == "torch":
                        self.torch.add(tgt)
                    elif root == "numpy":
                        self.np.add(tgt)
                    elif a.name == "time":
                        self.time_mod.add(a.asname or "time")
                    elif a.name == "random":
                        self.random_mod.add(a.asname or "random")
            elif isinstance(node, ast.ImportFrom):
                for a in node.names:
                    tgt = a.asname or a.name
                    if node.module == "time" and a.name in _TIME_FUNCS:
                        self.time_fn.add(tgt)
                    elif node.module == "torch.cuda" and a.name == "synchronize":
                        self.sync_fn.add(tgt)
                    elif node.module == "torch" and a.name == "compile":
                        self.compile_fn.add(tgt)

    def torch_attr(self, func: ast.expr) -> list[str] | None:
        """The attribute path after the torch alias (``torch.cuda.x`` ->
        ["cuda", "x"]), or None if ``func`` is not one."""
        chain = _chain(func)
        if chain and len(chain) > 1 and chain[0] in self.torch:
            return chain[1:]
        return None

    def is_compiler(self, func: ast.expr) -> bool:
        if isinstance(func, ast.Name):
            return func.id in self.compile_fn
        attr = self.torch_attr(func)
        return attr is not None and tuple(attr) in _COMPILERS

    def is_device_sync(self, call: ast.Call) -> bool:
        """``torch.cuda.synchronize()`` or any ``<x>.synchronize()``."""
        func = call.func
        if isinstance(func, ast.Name):
            return func.id in self.sync_fn
        return isinstance(func, ast.Attribute) and func.attr == "synchronize"


def _annotation_src(node: ast.expr | None) -> str:
    return ast.unparse(node) if node is not None else ""


def _all_params(fn: ast.FunctionDef) -> list[ast.arg]:
    a = fn.args
    return [*a.posonlyargs, *a.args, *a.kwonlyargs]


class _TensorNames:
    """Names bound to tensors in one function (and those it closes over)."""

    def __init__(self, fn: ast.FunctionDef, al: _Aliases, outer: set[str],
                 tensor_fns: set[str]):
        self.al = al
        self.tensor_fns = tensor_fns
        self.names = set(outer) | {
            a.arg for a in _all_params(fn) if "Tensor" in _annotation_src(a.annotation)}
        while True:   # to a fixpoint: a local may be bound from a later one
            before = len(self.names)
            for node in ast.walk(fn):
                self._bind(node)
            if len(self.names) == before:
                break

    def _bind_target(self, target: ast.expr, value: ast.expr | None, tensor: bool):
        if isinstance(target, ast.Name):
            if tensor or (value is not None and self.is_tensor(value)):
                self.names.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            if isinstance(value, (ast.Tuple, ast.List)) and len(value.elts) == len(target.elts):
                for t, v in zip(target.elts, value.elts):
                    self._bind_target(t, v, tensor)
            else:
                tensor = tensor or (value is not None and self.is_tensor(value))
                for t in target.elts:
                    self._bind_target(t, None, tensor)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, None, tensor)

    def _bind(self, node: ast.AST):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                self._bind_target(tgt, node.value, False)
        elif isinstance(node, ast.AnnAssign):
            self._bind_target(node.target, node.value,
                              "Tensor" in _annotation_src(node.annotation))
        elif isinstance(node, ast.AugAssign):
            self._bind_target(node.target, node.value, False)
        elif isinstance(node, ast.NamedExpr):
            self._bind_target(node.target, node.value, False)
        elif isinstance(node, (ast.For, ast.comprehension)):
            # iterating a tensor (or torch.aminmax's tuple of them) gives tensors
            self._bind_target(node.target, None, self.is_tensor(node.iter))

    def is_tensor(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Call):
            func = node.func
            attr = self.al.torch_attr(func)
            if attr is not None:
                return attr[0] not in _TORCH_NON_TENSOR_MODS \
                    and attr[-1] not in _TORCH_NON_TENSOR
            if isinstance(func, ast.Name):
                return func.id in self.tensor_fns
            return isinstance(func, ast.Attribute) and (
                func.attr in self.tensor_fns
                or (self.is_tensor(func.value) and func.attr not in _NON_TENSOR_METHODS))
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.Compare):
            return any(self.is_tensor(v) for v in (node.left, *node.comparators))
        if isinstance(node, ast.IfExp):
            return self.is_tensor(node.body) or self.is_tensor(node.orelse)
        if isinstance(node, ast.Attribute):
            return node.attr not in _HOST_ATTRS and self.is_tensor(node.value)
        return False


class _Scanner(ast.NodeVisitor):
    def __init__(self, relpath: str, al: _Aliases, hot: set[str],
                 tensor_fns: set[str]):
        self.relpath = relpath
        self.al = al
        self.hot = hot                       # qualnames of hot-path functions here
        self.tensor_fns = tensor_fns
        self.findings: list[Finding] = []
        self.scope: list[str] = []           # qualname parts
        self.fn_stack: list[ast.FunctionDef] = []
        self.hot_depth = 0
        self.tensors: _TensorNames | None = None
        self.span_depth = 0
        self.exempt_sync = any(p in relpath.split("/")
                               for p in EXEMPT_PATH_PARTS)
        self._decorator_calls: set[int] = set()   # id() of decorator exprs

    def _emit(self, code: str, node: ast.AST, message: str):
        self.findings.append(Finding(
            code=code, path=self.relpath, line=node.lineno, message=message,
            scope=".".join(self.scope)))

    def _is_tensor(self, node: ast.expr) -> bool:
        return self.tensors is not None and self.tensors.is_tensor(node)

    # ------------------------------------------------------------- visits
    def visit_ClassDef(self, node: ast.ClassDef):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    def _visit_function(self, node: ast.FunctionDef):
        compiled = [d for d in node.decorator_list
                    if self.al.is_compiler(d.func if isinstance(d, ast.Call) else d)]
        # decorators execute in the *enclosing* scope: visit them before
        # entering the function, so a decorator on a module-level def is not
        # taken for a call inside a function body
        for dec in node.decorator_list:
            self._decorator_calls.add(id(dec))
            self.visit(dec)
        if compiled and self.fn_stack and self.fn_stack[-1].name != "__init__":
            self.scope.append(node.name)
            self._emit("RT102", node,
                       f"compiled {node.name!r} defined inside "
                       f"{self.fn_stack[-1].name!r}: a fresh compile per call")
            self.scope.pop()
        self.scope.append(node.name)
        hot = self.hot_depth > 0 or ".".join(self.scope) in self.hot
        prev = self.tensors
        if hot:
            self.hot_depth += 1
            self.tensors = _TensorNames(node, self.al,
                                        prev.names if prev is not None else set(),
                                        self.tensor_fns)
        self.fn_stack.append(node)
        for field, value in ast.iter_fields(node):
            if field == "decorator_list":
                continue
            for child in (value if isinstance(value, list) else [value]):
                if isinstance(child, ast.AST):
                    self.visit(child)
        self.fn_stack.pop()
        if hot:
            self.hot_depth -= 1
            self.tensors = prev
        self.scope.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_With(self, node: ast.With):
        is_span = any(
            isinstance(item.context_expr, ast.Call)
            and ((isinstance(item.context_expr.func, ast.Attribute)
                  and item.context_expr.func.attr in ("span", "trace"))
                 or (isinstance(item.context_expr.func, ast.Name)
                     and item.context_expr.func.id == "trace"))
            for item in node.items)
        if is_span:
            self.span_depth += 1
        self.generic_visit(node)
        if is_span:
            self.span_depth -= 1

    def visit_Call(self, node: ast.Call):
        al = self.al
        func = node.func
        hot = self.hot_depth > 0
        arg0 = node.args[0] if node.args else None

        # a compiler applied inside a function body (RT102); __init__ is
        # the sanctioned place to build per-instance wrappers
        if al.is_compiler(func) and self.fn_stack \
                and self.fn_stack[-1].name != "__init__" \
                and id(node) not in self._decorator_calls:
            self._emit("RT102", node,
                       f"{ast.unparse(func)}(...) called inside "
                       f"{self.fn_stack[-1].name!r}: a fresh compile per call")

        if al.is_device_sync(node):
            what = ast.unparse(func)
            if hot:
                self._emit("RT101", node,
                           f"{what}() inside a hot-path function waits for "
                           "the card")
            elif self.span_depth == 0 and not self.exempt_sync:
                self._emit("RT105", node,
                           f"{what}() outside a Tracer span: the wait is "
                           "invisible to the profile")
        elif hot:
            self._check_hot_call(node, func, arg0)
        self.generic_visit(node)

    def _check_hot_call(self, node: ast.Call, func: ast.expr, arg0):
        al = self.al
        no_generator = all(kw.arg != "generator" for kw in node.keywords)
        if isinstance(func, ast.Name):
            if func.id in _HOST_CASTS and len(node.args) == 1 \
                    and self._is_tensor(arg0):
                self._emit("RT101", node,
                           f"{func.id}({ast.unparse(arg0)}) of a tensor reads "
                           "it back to the host")
            elif func.id in al.time_fn:
                self._emit("RT104", node,
                           f"{func.id}() puts a host clock into the step")
            return
        if not isinstance(func, ast.Attribute):
            return
        chain = _chain(func)
        torch_attr = al.torch_attr(func)
        if func.attr in _HOST_METHODS and torch_attr is None \
                and not _is_cpu_call(func.value):   # x.cpu().numpy(): one read
            self._emit("RT101", node,
                       f".{func.attr}() inside a hot-path function reads a "
                       "tensor back to the host")
        elif chain and len(chain) == 2 and chain[0] in al.np \
                and chain[1] in _NP_SYNC_FUNCS and self._is_tensor(arg0):
            self._emit("RT101", node,
                       f"np.{func.attr}({ast.unparse(arg0)}) copies a tensor "
                       "to the host")
        elif chain and len(chain) == 2 and chain[0] in al.time_mod \
                and chain[1] in _TIME_FUNCS:
            self._emit("RT104", node,
                       f"time.{func.attr}() puts a host clock into the step")
        elif chain and len(chain) == 2 and chain[0] in al.random_mod:
            self._emit("RT104", node,
                       f"random.{func.attr}() draws from the process-wide "
                       "generator")
        elif chain and len(chain) == 3 and chain[0] in al.np \
                and chain[1] == "random":
            self._emit("RT104", node,
                       f"np.random.{func.attr}() draws from the process-wide "
                       "generator")
        elif torch_attr is not None and len(torch_attr) == 1 \
                and torch_attr[0] in _TORCH_DRAWS and no_generator:
            self._emit("RT104", node,
                       f"torch.{func.attr}() without generator= draws from "
                       "the process-wide generator")
        elif torch_attr is None and func.attr in _TENSOR_DRAWS and no_generator \
                and self._is_tensor(func.value):
            self._emit("RT104", node,
                       f".{func.attr}() without generator= draws from the "
                       "process-wide generator")


def scan_source(source: str, relpath: str,
                hot_paths: Iterable[str] = HOT_PATHS) -> list[Finding]:
    """Run the host-sync pass over one module's source; ``relpath`` is its
    repo-relative path, which selects its functions of ``hot_paths``
    (``path::qualname`` entries)."""
    tree = ast.parse(source, filename=relpath)
    entries = [e.partition("::") for e in hot_paths]
    hot = {q for path, _, q in entries if path == relpath}
    tensor_fns = {q for _, _, q in entries if "." not in q}
    sc = _Scanner(relpath, _Aliases(tree), hot, tensor_fns)
    sc.visit(tree)
    return sc.findings
