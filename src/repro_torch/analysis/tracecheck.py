"""AST-based host-sync linter over ``src/repro_torch``.

The port's cycle loop keeps one device-to-host sync per iteration: the
packed read of the busy verdicts and horizons that decides the next
fast-forward jump.  Every other read of a CUDA tensor on the host stalls
the loop until the device has drained its queue, and the kernel launches
behind it wait with it.  Such reads hide in ordinary Python: an ``if``
on a tensor, ``int(t)``, ``.tolist()``, ``np.*`` on a tensor, and torch
calls that read back on their own (``masked_fill`` with a 0-d tensor
value, or any op whose output shape depends on the data).  A runtime
test sees them only on the paths it drives; this pass finds them in the
source (the counterpart of the reference's JAX trace-safety lint).

Rules
-----
* ``TS101`` — Python ``if``/``while``/ternary/``assert``/``and``/``or``/
  ``not`` on a tensor in a hot context: ``bool(t)`` waits for the
  device.  ``x is None``, ``isinstance``, ``len(x)``, ``x.shape``,
  ``x.dtype``, ``x.device``, ``x.dim()`` and ``x.numel()`` read no data.
* ``TS102`` — host coercion of a tensor (``.item()``, ``.tolist()``,
  ``int()``, ``float()``, ``bool()``) in a hot context.
* ``TS103`` — device-to-host copy (``.cpu()``, ``.numpy()``,
  ``.to("cpu")``, ``np.*`` on a tensor) in a hot context.
* ``TS104`` — non-hashable closure capture (list/dict/set) in a
  callable passed to a cache-keyed sink (``extra_predicates``), anywhere:
  the ``RunCache`` freezes callables by closure contents, and mutable
  captures either fail to hash or alias stale state.
* ``TS105`` — a module imports ``jax``, ``jaxlib``, ``ml_dtypes`` or the
  reference package ``repro``, anywhere: the port stands alone.
* ``TS106`` — a sync only torch has, in a hot context: ``masked_fill`` /
  ``index_fill`` with a tensor value (read back as a Python scalar), and
  ops whose output shape depends on the data (``nonzero``, ``argwhere``,
  ``unique``, ``masked_select``, one-argument ``torch.where``,
  ``repeat_interleave`` by a tensor of repeats without ``output_size``).

Hot contexts are the loops of :data:`HOT_LOOPS` (the cycle loop of
``engine.make_run``'s ``run``: its ``for clk in range(n_cycles)`` and
``while True`` bodies), then every same-project function they call,
transitively, by import-alias resolution.  What runs after the loop is
not hot.  Within a context, tensor values propagate forward from
``torch.*`` producers, tensor methods, calls of project functions on
tensors and the parameters of hot callees; a parameter annotated with a
host type (``int``, ``bool``, the specs and configs of
:data:`HOST_TYPES`, any type but a tensor, a container or a project
class) is a host value, and the fields of a project ``NamedTuple`` or
dataclass follow their own annotations (the ``int`` timings of
``DynParams`` are host values, its ``ct_lat`` a tensor).  The result of a sync (``.tolist()``, ``int(t)``) is a host
value.  ``isinstance(x, torch.Tensor)`` narrows ``x`` in the branches it
guards.

Suppression: append ``# lint: ignore[ts102]`` (comma-separate several
ids) to the offending line, or put ``# lint: skip-file`` near the top
of a file.  Suppressions are per-rule by design: a bare ``ignore`` does
not parse.
"""
from __future__ import annotations

import ast
import io
import os
import re
import tokenize

from repro_torch.analysis.report import ERROR, Finding, LintReport

#: the hot loops: (module-name suffix, function qualname); the loops of
#: that function's own body (not of nested defs) are the roots
HOT_LOOPS = (("core.engine", "make_run.run"),)

#: the hot functions: (module-name suffix, function qualname); the whole
#: body is a root (a training step runs once per iteration of its
#: caller's loop, and says it makes no host sync of its own)
HOT_FUNCS = (("train.step", "make_train_step.step"),)

#: the port's classes whose instances are host values though they are
#: project classes (any other named type but a tensor, a container or a
#: project class is a host value already: ``int``, ``bool``, ``dict``...)
HOST_TYPES = frozenset({"CompiledSpec", "MemorySystemSpec",
                        "ControllerConfig", "FrontendConfig"})

#: annotations that may hold tensors: the tensor type, containers and
#: the untyped
_TENSORISH = frozenset({"Tensor", "tuple", "list", "Tuple", "List",
                        "Sequence", "Iterable", "Mapping", "object", "Any",
                        "?"})

#: packages the port must not import (TS105)
FOREIGN = ("jax", "jaxlib", "ml_dtypes", "repro")

#: sinks whose callable arguments are frozen into cache keys (TS104)
_CACHE_KEYED_KWARGS = frozenset({"extra_predicates"})

#: attributes of a tensor that read no data (a DTensor's placements and
#: mesh among them)
_HOST_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda",
                         "layout", "requires_grad", "is_leaf",
                         "placements", "device_mesh"})
#: tensor methods whose result is a host value (``tolist``/``item`` sync,
#: and are reported; the others read metadata only)
_HOST_METHODS = frozenset({"dim", "numel", "size", "tolist", "item",
                           "data_ptr", "stride", "is_contiguous",
                           "element_size", "nelement", "get_device",
                           "is_floating_point", "storage_offset",
                           "untyped_storage", "cpu", "numpy"})
#: torch callables that make no tensor
_TORCH_HOST = frozenset({"device", "is_tensor", "Size", "iinfo", "finfo",
                         "get_default_dtype", "dtype", "no_grad",
                         "inference_mode", "is_grad_enabled", "Generator",
                         "cuda", "profiler", "Tensor"})
#: builtins whose result is a host value whatever they are given
_HOST_BUILTINS = frozenset({"int", "float", "bool", "len", "isinstance",
                            "range", "str", "repr", "hash", "id", "type",
                            "callable", "hasattr", "print", "format",
                            "issubclass", "chr", "ord", "object",
                            "super", "vars", "dir", "divmod", "round"})
#: ops whose output shape depends on the data (TS106)
_DATA_SHAPED = frozenset({"nonzero", "argwhere", "unique",
                          "unique_consecutive", "masked_select"})

_IGNORE_RE = re.compile(r"#\s*lint:\s*ignore\[([a-zA-Z0-9_,\s-]+)\]")
_SKIP_RE = re.compile(r"#\s*lint:\s*skip-file")


# ---------------------------------------------------------------------------
# per-module model
# ---------------------------------------------------------------------------

class Module:
    """One parsed source file: AST + import aliases + function index."""

    def __init__(self, path: str, name: str, tree: ast.Module,
                 source: str):
        self.path = path
        self.name = name                    # dotted module name
        self.tree = tree
        self.lines = source.splitlines()
        self.aliases: dict = {}             # local alias -> dotted module
        self.from_imports: dict = {}        # local name -> (module, attr)
        self.functions: dict = {}           # qualname -> FunctionDef
        self.qualnames: dict = {}           # id(FunctionDef) -> qualname
        self.classes: dict = {}             # class name -> ClassDef
        self._comment_map = None
        self._index()

    def _index(self):
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    full = f"{node.module}.{a.name}"
                    self.from_imports[a.asname or a.name] = (node.module,
                                                             a.name)
                    # `from pkg.core import engine as E` is a module alias
                    self.aliases.setdefault(a.asname or a.name, full)

        def visit(node, prefix=""):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    q = f"{prefix}{child.name}"
                    self.functions[q] = child
                    self.qualnames[id(child)] = q
                    visit(child, prefix=f"{q}.")
                elif isinstance(child, ast.ClassDef):
                    self.classes.setdefault(child.name, child)
                    visit(child, prefix=f"{prefix}{child.name}.")
                else:
                    visit(child, prefix=prefix)
        visit(self.tree)

    def imported_modules(self):
        """(line, dotted module) of every import statement."""
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    yield node.lineno, a.name
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                yield node.lineno, node.module

    def roots(self, target: str) -> set:
        """Local names that alias the module ``target`` or its children."""
        out = {alias for alias, mod in self.aliases.items()
               if mod == target or mod.startswith(target + ".")}
        out |= {alias for alias, (mod, _a) in self.from_imports.items()
                if mod == target or mod.startswith(target + ".")}
        return out

    def _comments(self) -> dict:
        """{line: comment text} of the source's comments (a docstring
        that quotes the syntax suppresses nothing)."""
        if self._comment_map is None:
            self._comment_map = {}
            src = io.StringIO("\n".join(self.lines) + "\n")
            for tok in tokenize.generate_tokens(src.readline):
                if tok.type == tokenize.COMMENT:
                    self._comment_map[tok.start[0]] = tok.string
        return self._comment_map

    def suppressed(self, line: int) -> set:
        """Rule ids suppressed on a 1-indexed source line."""
        m = _IGNORE_RE.search(self._comments().get(line, ""))
        if m:
            return {t.strip().lower() for t in m.group(1).split(",")}
        return set()

    def suppressions(self) -> list:
        """``(line, rule ids)`` of every per-line suppression."""
        return [(line, sorted(self.suppressed(line)))
                for line in sorted(self._comments())
                if self.suppressed(line)]

    def skip_file(self) -> bool:
        return any(_SKIP_RE.search(c) for line, c in self._comments().items()
                   if line <= 5)


def _module_name(path: str, root: str) -> str:
    rel = os.path.relpath(path, root)
    parts = rel[:-3].split(os.sep)          # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def load_modules(paths, root: str | None = None) -> dict:
    """Parse every ``.py`` under ``paths`` into {dotted name: Module}.

    ``root`` is the directory whose children are top-level packages
    (defaults to the parent of the first directory given — for this
    repo, ``src/``)."""
    files = []
    dir_roots = []
    for p in paths:
        if os.path.isdir(p):
            dir_roots.append(os.path.dirname(os.path.abspath(p)))
            for dirpath, _dirs, names in os.walk(p):
                files += [os.path.join(dirpath, n) for n in names
                          if n.endswith(".py")]
        elif p.endswith(".py"):
            files.append(p)
    files = sorted(set(files))
    if root is None:
        root = dir_roots[0] if dir_roots else _guess_root(files)
    out = {}
    for path in files:
        with open(path) as fh:
            src = fh.read()
        tree = ast.parse(src, filename=path)
        name = _module_name(path, root)
        out[name] = Module(path, name, tree, src)
    return out


def _guess_root(files) -> str:
    """The ancestor directory that makes ``files`` importable packages
    (walk up while ``__init__.py`` is present)."""
    if not files:
        return "."
    d = os.path.dirname(os.path.abspath(files[0]))
    while os.path.exists(os.path.join(d, "__init__.py")):
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return d


# ---------------------------------------------------------------------------
# hot-context discovery
# ---------------------------------------------------------------------------

def _own_nodes(node):
    """Walk a node's subtree without descending into nested defs (they
    are their own contexts)."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))


def hot_loops(fn) -> list:
    """The outermost ``for``/``while`` statements of a function's own
    body."""
    out = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.For, ast.While)):
                out.append(child)
            elif not isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Lambda,
                                        ast.ClassDef)):
                visit(child)
    visit(fn)
    return out


def _func_name(node):
    """A call's callee as a (possibly dotted) name: ``f`` or ``mod.f``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        return f"{node.value.id}.{node.attr}"
    return None


class ContextIndex:
    """Project-wide set of hot-context functions.

    Keys are ``(module name, function qualname)``.  The roots are the
    functions of :data:`HOT_LOOPS` (only their loops are hot: ``roots``
    maps each to its loop nodes); the other contexts are every
    same-project function those loops reach."""

    def __init__(self, modules: dict):
        self.modules = modules
        self.roots: dict = {}               # (mod, qual) -> [loop nodes]
        for mod in modules.values():
            for roots, of in ((HOT_LOOPS, hot_loops),
                              (HOT_FUNCS, lambda fn: list(fn.body))):
                for suffix, qual in roots:
                    if (mod.name == suffix
                        or mod.name.endswith("." + suffix)) \
                            and qual in mod.functions:
                        self.roots[(mod.name, qual)] = of(
                            mod.functions[qual])
        self.contexts: set = set()
        self._close_over_callees()

    def resolve(self, mod: Module, name: str, scope: str = ""):
        """Resolve a (possibly dotted) local name called from function
        ``scope`` to (module, qualname): a nested def of the scope or of
        an enclosing one, a module-level def, a from-import or an
        attribute of a module alias."""
        if name is None:
            return None
        if "." in name:
            base, attr = name.split(".", 1)
            target = mod.aliases.get(base)
            if target in self.modules and attr in self.modules[target] \
                    .functions:
                return (target, attr)
            return None
        parts = scope.split(".") if scope else []
        for i in range(len(parts), -1, -1):
            q = ".".join(parts[:i] + [name])
            if q in mod.functions:
                return (mod.name, q)
        if name in mod.from_imports:
            m, attr = mod.from_imports[name]
            if m in self.modules and attr in self.modules[m].functions:
                return (m, attr)
        return None

    def callees(self, mod: Module, nodes, scope: str):
        fn = mod.functions.get(scope)
        for top in nodes:
            for node in ast.walk(top):
                if isinstance(node, ast.Call):
                    yield from self._targets(mod, node.func, scope, fn)

    def _targets(self, mod: Module, func, scope: str, fn, depth=0):
        """The functions a callee expression may denote: a resolvable
        name, or a local alias of them (``step = C.a if x else C.b``)."""
        key = self.resolve(mod, _func_name(func), scope)
        if key is not None:
            yield key
        elif isinstance(func, ast.Name) and fn is not None and depth < 4:
            for n in _own_nodes(fn):
                if isinstance(n, ast.Assign) and any(
                        isinstance(t, ast.Name) and t.id == func.id
                        for t in n.targets):
                    for ref in ast.walk(n.value):
                        if isinstance(ref, (ast.Name, ast.Attribute)) \
                                and ref is not func:
                            yield from self._targets(mod, ref, scope, fn,
                                                     depth + 1)

    def _close_over_callees(self):
        """Transitive closure over same-project callees of the loops."""
        work = []
        for (mname, qual), loops in self.roots.items():
            work += list(self.callees(self.modules[mname], loops, qual))
        while work:
            key = work.pop()
            if key in self.contexts:
                continue
            self.contexts.add(key)
            mod = self.modules[key[0]]
            fn = mod.functions[key[1]]
            work += list(self.callees(mod, [fn], key[1]))


# ---------------------------------------------------------------------------
# tensor inference + rule checks
# ---------------------------------------------------------------------------
#
# A value's kind is None (a host value), TENSOR (a tensor, or a container
# or unknown structure holding tensors) or a project class name (its
# fields follow their annotations).

TENSOR = "tensor"
_UNSET = "unset"                            # a field __init__ sets to None


def _annotation_names(node) -> list:
    if node is None:
        return []
    if isinstance(node, ast.Constant):
        if isinstance(node.value, str):
            try:
                return _annotation_names(ast.parse(node.value,
                                                   mode="eval").body)
            except SyntaxError:
                return []
        return []                           # None
    if isinstance(node, ast.Name):
        return [node.id]
    if isinstance(node, ast.Attribute):
        return [node.attr]
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return _annotation_names(node.left) + _annotation_names(node.right)
    if isinstance(node, ast.Subscript):
        head = _annotation_names(node.value)
        if head and head[0] == "Optional":
            return _annotation_names(node.slice)
        return head
    return ["?"]


class _Project:
    """Project-wide lookups shared by the function linters: classes and
    their field annotations, and the index of callable defs."""

    def __init__(self, modules: dict, index: ContextIndex):
        self.modules = modules
        self.index = index
        self.classes: dict = {}             # name -> {field: annotation}
        self.class_home: dict = {}          # name -> (module, ClassDef)
        for mod in modules.values():
            for name, cls in mod.classes.items():
                fields = {}
                for stmt in cls.body:
                    if isinstance(stmt, ast.AnnAssign) \
                            and isinstance(stmt.target, ast.Name):
                        fields[stmt.target.id] = stmt.annotation
                self.classes.setdefault(name, fields)
                self.class_home.setdefault(name, (mod, cls))
        self._states: dict = {}

    def kind_of_annotation(self, node, default=TENSOR):
        """A tensor for ``torch.Tensor`` and for containers (they may
        hold tensors), a project class for one of its NamedTuples or
        dataclasses (its fields follow their own annotations), a host
        value for :data:`HOST_TYPES` and any other named type."""
        names = [n for n in _annotation_names(node) if n != "None"]
        if not names:
            return default
        if any(n in _TENSORISH for n in names):
            return TENSOR
        objs = [n for n in names
                if n in self.classes and n not in HOST_TYPES]
        if not objs:
            return None
        return objs[0] if len(objs) == len(names) == 1 else TENSOR

    def field_kind(self, cls: str, attr: str):
        """The kind of attribute ``attr`` of a ``cls`` instance: its
        class-level annotation, else what ``__init__`` assigns to it (a
        host value where that is None: annotate a field that later holds
        tensors; a tensor where ``__init__`` does not set it)."""
        if attr == "_replace":
            return cls
        ann = self.classes.get(cls, {}).get(attr)
        if ann is not None:
            return self.kind_of_annotation(ann)
        return self._init_fields(cls).get(attr, TENSOR)

    def _init_fields(self, cls: str) -> dict:
        key = ("__init__", cls)
        if key not in self._states:
            self._states[key] = {}          # recursion guard
            init = self.method(cls, "__init__")
            if init is not None:
                mod = self.class_home[cls][0]
                lint = _FunctionLint(self, mod, mod.qualnames[id(init)],
                                     hot=False)
                lint.run()
                self._states[key] = {
                    k: None if v == _UNSET else v
                    for k, v in lint.self_fields.items()}
        return self._states[key]

    def method(self, cls: str, attr: str):
        home = self.class_home.get(cls)
        if home is None:
            return None
        mod, node = home
        for q, fn in mod.functions.items():
            if q.endswith(f"{node.name}.{attr}") and fn in node.body:
                return fn
        return None

    def enclosing_state(self, mod: Module, qual: str) -> dict:
        """The kinds an enclosing function leaves to a nested def."""
        if "." not in qual:
            return {}
        outer = qual.rsplit(".", 1)[0]
        if outer not in mod.functions:
            return {}
        key = (mod.name, outer)
        if key not in self._states:
            self._states[key] = {}          # recursion guard
            lint = _FunctionLint(self, mod, outer, hot=False)
            lint.run()
            self._states[key] = lint.final_state
        return self._states[key]


class _FunctionLint(ast.NodeVisitor):
    """Forward tensor-kind propagation + rule checks for one function.

    ``hot`` is True for a hot callee (every statement is checked) or the
    list of loop nodes of a root (only those are checked)."""

    def __init__(self, proj: _Project, mod: Module, qual: str, hot):
        self.proj = proj
        self.mod = mod
        self.qual = qual
        self.fn = mod.functions[qual]
        self.hot_roots = None if hot is True else {id(n) for n in hot or ()}
        self.in_hot = hot is True
        self.torch = mod.roots("torch")
        self.np = mod.roots("numpy")
        self.env: dict = dict(proj.enclosing_state(mod, qual))
        args = self.fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs + [
                x for x in (args.vararg, args.kwarg) if x]:
            if a.arg in ("self", "cls"):
                self.env[a.arg] = None
            else:
                self.env[a.arg] = proj.kind_of_annotation(a.annotation)
        self.findings: dict = {}            # (rule, line, col) -> Finding
        self.final_state: dict = {}
        self.self_fields: dict = {}         # attr -> kind of self.attr = ...

    # -- kinds ---------------------------------------------------------------
    def kind(self, node):
        """The kind of an expression (None: a host value)."""
        if node is None or isinstance(node, (ast.Constant, ast.Lambda,
                                             ast.JoinedStr)):
            return None
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name) \
                    and node.value.id in self.mod.aliases \
                    and node.value.id not in self.env:
                return None                 # a module attribute
            base = self.kind(node.value)
            if base is None or node.attr in _HOST_ATTRS:
                return None
            if base == TENSOR:
                return TENSOR
            return self.proj.field_kind(base, node.attr)
        if isinstance(node, ast.Subscript):
            base = self.kind(node.value)
            return None if base is None else TENSOR
        if isinstance(node, ast.Starred):
            return self.kind(node.value)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return None
            if any(_is_meta(n) for n in [node.left] + node.comparators):
                return None                 # shape/dtype/device checks
            return self._any([node.left] + node.comparators)
        if isinstance(node, ast.BinOp):
            return self._any([node.left, node.right])
        if isinstance(node, ast.UnaryOp):
            return self._any([node.operand])
        if isinstance(node, ast.BoolOp):
            return self._any(node.values)
        if isinstance(node, ast.IfExp):
            yes, no = self._narrowing(node.test)
            out = []
            self._with(yes, lambda: out.append(self.kind(node.body)))
            self._with(no, lambda: out.append(self.kind(node.orelse)))
            return TENSOR if TENSOR in out else next(
                (k for k in out if k is not None), None)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return self._any(node.elts)
        if isinstance(node, ast.Dict):
            return self._any([v for v in node.values if v is not None])
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            self._bind_generators(node.generators)
            return self._any([node.elt])
        if isinstance(node, ast.DictComp):
            self._bind_generators(node.generators)
            return self._any([node.value])
        if isinstance(node, ast.Call):
            return self._call_kind(node)
        if isinstance(node, ast.NamedExpr):
            return self.kind(node.value)
        return None

    def _any(self, nodes):
        kinds = [self.kind(n) for n in nodes]
        if TENSOR in kinds:
            return TENSOR
        objs = [k for k in kinds if k is not None]
        return objs[0] if objs else None

    def is_tensor(self, node) -> bool:
        return self.kind(node) is not None

    def _call_kind(self, node: ast.Call):
        fn = node.func
        args = list(node.args) + [kw.value for kw in node.keywords]
        if isinstance(fn, ast.Name):
            if fn.id in _HOST_BUILTINS and fn.id not in self.env:
                return None
            if fn.id in self.proj.classes and fn.id not in self.env:
                return fn.id                # a project class's instance
            bound = self._lambda_of(fn.id)
            if bound is not None:
                return self._apply_lambda(bound, node)
        name = _func_name(fn)
        if isinstance(fn, ast.Attribute):
            root = fn.value
            while isinstance(root, ast.Attribute):
                root = root.value
            if isinstance(root, ast.Name) and root.id in self.torch \
                    and root.id not in self.env:
                inner = fn
                while isinstance(inner.value, ast.Attribute):
                    inner = inner.value
                return None if (inner.attr in _TORCH_HOST
                                or fn.attr in _TORCH_HOST) else TENSOR
            if isinstance(root, ast.Name) and root.id in self.np \
                    and root.id not in self.env:
                return None                 # numpy makes host arrays
            recv = self.kind(fn.value)
            if recv == TENSOR:
                return None if fn.attr in _HOST_METHODS else TENSOR
            if recv is not None:            # a project object's method
                if fn.attr == "_replace":
                    return recv
                m = self.proj.method(recv, fn.attr)
                if m is not None and m.returns is not None:
                    return self.proj.kind_of_annotation(m.returns)
                return self._any(args)
            if fn.attr in self.proj.classes and self._is_module(fn.value):
                return fn.attr
        key = self.proj.index.resolve(self.mod, name, self.qual)
        if key is not None:
            target = self.proj.modules[key[0]].functions[key[1]]
            if target.returns is not None:
                return self.proj.kind_of_annotation(target.returns)
            return self._any(args)
        if isinstance(fn, ast.Attribute):
            return None                     # a host object's method
        return self._any(args)

    def _is_module(self, node) -> bool:
        return isinstance(node, ast.Name) and node.id in self.mod.aliases \
            and node.id not in self.env

    def _lambda_of(self, name: str):
        for n in _own_nodes(self.fn):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Lambda) \
                    and any(isinstance(t, ast.Name) and t.id == name
                            for t in n.targets):
                return n.value
        return None

    def _apply_lambda(self, lam: ast.Lambda, call: ast.Call):
        """The kind a local lambda returns for this call's arguments."""
        params = [a.arg for a in lam.args.args]
        saved = {p: self.env.get(p, None) for p in params}
        had = {p for p in params if p in self.env}
        for p, a in zip(params, call.args):
            self.env[p] = self.kind(a)
        try:
            return self.kind(lam.body)
        finally:
            for p in params:
                if p in had:
                    self.env[p] = saved[p]
                else:
                    self.env.pop(p, None)

    def _bind_generators(self, gens):
        for g in gens:
            k = self.kind(g.iter)
            for t in self._targets(g.target):
                self.env[t] = TENSOR if k is not None else None

    # -- isinstance narrowing -----------------------------------------------
    def _narrowing(self, test):
        """``{name: kind}`` in the branch a test guards, and in its
        ``else``: ``isinstance(x, torch.Tensor)`` makes ``x`` a tensor
        there and a host value in the other branch."""
        neg = False
        while isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            neg, test = not neg, test.operand
        if isinstance(test, ast.Call) and isinstance(test.func, ast.Name) \
                and test.func.id == "isinstance" and len(test.args) == 2 \
                and isinstance(test.args[0], ast.Name):
            cls = test.args[1]
            is_tensor_cls = (
                (isinstance(cls, ast.Attribute) and cls.attr == "Tensor")
                or (isinstance(cls, ast.Name) and cls.id == "Tensor"))
            if is_tensor_cls:
                x = test.args[0].id
                yes, no = {x: TENSOR}, {x: None}
                return (no, yes) if neg else (yes, no)
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And) \
                and not neg:
            yes = {}
            for v in test.values:
                yes.update(self._narrowing(v)[0])
            return yes, {}
        return {}, {}

    def _with(self, narrowed: dict, fn):
        saved = {k: self.env.get(k) for k in narrowed}
        had = {k for k in narrowed if k in self.env}
        self.env.update(narrowed)
        try:
            fn()
        finally:
            for k in narrowed:
                if k in had:
                    self.env[k] = saved[k]
                else:
                    self.env.pop(k, None)

    # -- findings ------------------------------------------------------------
    def emit(self, rule, node, msg):
        if not self.in_hot:
            return
        line = getattr(node, "lineno", 0)
        if rule.lower() in self.mod.suppressed(line):
            return
        key = (rule, line, getattr(node, "col_offset", 0))
        self.findings.setdefault(key, Finding(
            rule=rule, severity=ERROR, message=msg, target=self.mod.name,
            path=self.mod.path, line=line))

    def _test(self, node, what):
        if self.is_tensor(node):
            self.emit("TS101", node,
                      f"Python {what} on a tensor in the hot loop: "
                      "bool(tensor) waits for the device (a host sync "
                      "per call on CUDA); keep the decision on the device "
                      "(torch.where) or read it in the iteration's one sync")

    # -- statements ----------------------------------------------------------
    def _targets(self, target):
        if isinstance(target, ast.Name):
            yield target.id
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                yield from self._targets(el)
        elif isinstance(target, ast.Starred):
            yield from self._targets(target.value)

    def _assign(self, target, kind, value=None):
        if isinstance(target, ast.Name):
            self.env[target.id] = kind
        elif isinstance(target, ast.Attribute) \
                and isinstance(target.value, ast.Name) \
                and target.value.id == "self":
            fields = self.self_fields
            if isinstance(value, ast.Constant) and value.value is None:
                fields.setdefault(target.attr, _UNSET)
            elif fields.get(target.attr, _UNSET) == _UNSET:
                fields[target.attr] = kind
            elif kind is not None:
                fields[target.attr] = TENSOR
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._assign(el.value if isinstance(el, ast.Starred)
                             else el, None if kind is None else TENSOR)

    def visit(self, node):
        if self.hot_roots is not None and id(node) in self.hot_roots:
            was, self.in_hot = self.in_hot, True
            try:
                return super().visit(node)
            finally:
                self.in_hot = was
        return super().visit(node)

    def visit_Assign(self, node):
        self.visit(node.value)
        k = self.kind(node.value)
        for t in node.targets:
            if isinstance(t, ast.Attribute):
                self.visit(t)
            if isinstance(t, (ast.Name, ast.Tuple, ast.List,
                              ast.Attribute)):
                self._assign(t, k, node.value)
            else:
                self.visit(t)

    def visit_AugAssign(self, node):
        self.generic_visit(node)
        if isinstance(node.target, ast.Name):
            self.env[node.target.id] = self._any([node.target, node.value])

    def visit_AnnAssign(self, node):
        if node.value is not None:
            self.visit(node.value)
            if isinstance(node.target, ast.Name):
                self.env[node.target.id] = self.kind(node.value)

    def _branches(self, test, body, orelse):
        yes, no = self._narrowing(test)
        before = dict(self.env)
        self._with(yes, lambda: [self.visit(s) for s in body])
        after_body = self.env
        self.env = dict(before)
        self._with(no, lambda: [self.visit(s) for s in orelse])
        if _exits(body) and not _exits(orelse):
            self.env.update(no)     # what follows runs only when it failed
            return
        if _exits(orelse) and not _exits(body):
            self.env = after_body
            self.env.update(yes)
            return
        for k, v in after_body.items():       # merge the branches
            if self.env.get(k) is None:
                self.env[k] = v
            elif v == TENSOR:
                self.env[k] = TENSOR

    def visit_If(self, node):
        self.visit(node.test)
        self._test(node.test, "`if`")
        self._branches(node.test, node.body, node.orelse)

    def visit_IfExp(self, node):
        self.visit(node.test)
        self._test(node.test, "ternary")
        yes, no = self._narrowing(node.test)
        self._with(yes, lambda: self.visit(node.body))
        self._with(no, lambda: self.visit(node.orelse))

    def visit_Assert(self, node):
        self.generic_visit(node)
        self._test(node.test, "`assert`")

    def visit_BoolOp(self, node):
        self.generic_visit(node)
        for v in node.values[:-1]:          # each of these is bool()-ed
            self._test(v, "`and`/`or`")

    def visit_UnaryOp(self, node):
        self.generic_visit(node)
        if isinstance(node.op, ast.Not):
            self._test(node.operand, "`not`")

    def _loop_twice(self, body_fn):
        # a value assigned late in a loop body reaches its top on the
        # next iteration: run the body twice (findings are deduplicated)
        for _ in range(2):
            before = dict(self.env)
            body_fn()
            for k, v in before.items():
                if v is not None and self.env.get(k) is None:
                    self.env[k] = v

    def visit_For(self, node):
        self.visit(node.iter)
        k = self.kind(node.iter)

        def body():
            self._assign(node.target, TENSOR if k is not None else None)
            for s in node.body:
                self.visit(s)
        self._loop_twice(body)
        for s in node.orelse:
            self.visit(s)

    def visit_While(self, node):
        def body():
            self.visit(node.test)
            self._test(node.test, "`while`")
            for s in node.body:
                self.visit(s)
        self._loop_twice(body)
        for s in node.orelse:
            self.visit(s)

    def visit_comprehension(self, node):
        self.visit(node.iter)
        self._bind_generators([node])
        for cond in node.ifs:
            self.visit(cond)
            self._test(cond, "comprehension `if`")

    def visit_ListComp(self, node):
        for g in node.generators:
            self.visit_comprehension(g)
        self.visit(node.elt)

    visit_SetComp = visit_GeneratorExp = visit_ListComp

    def visit_DictComp(self, node):
        for g in node.generators:
            self.visit_comprehension(g)
        self.visit(node.key)
        self.visit(node.value)

    def visit_Lambda(self, node):
        params = [a.arg for a in node.args.args]
        self._with({p: None for p in params}, lambda: self.visit(node.body))

    def visit_FunctionDef(self, node):
        if node is self.fn:
            for s in node.body:
                self.visit(s)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node):
        pass

    # -- calls ---------------------------------------------------------------
    def visit_Call(self, node):
        self.generic_visit(node)
        fn = node.func
        args = node.args
        kw = {k.arg: k.value for k in node.keywords if k.arg}
        attr = fn.attr if isinstance(fn, ast.Attribute) else None
        recv_tensor = attr is not None and self.kind(fn.value) == TENSOR
        torch_call = (attr is not None and isinstance(fn.value, ast.Name)
                      and fn.value.id in self.torch
                      and fn.value.id not in self.env)
        # TS102: int()/float()/bool() on a tensor; .item()/.tolist()
        if isinstance(fn, ast.Name) and fn.id in ("int", "float", "bool") \
                and fn.id not in self.env and args \
                and self.is_tensor(args[0]):
            self.emit("TS102", node,
                      f"`{fn.id}()` of a tensor in the hot loop: reads it "
                      "back to the host (a device sync on CUDA)")
        if attr in ("item", "tolist") and recv_tensor:
            self.emit("TS102", node,
                      f"`.{attr}()` in the hot loop: reads the tensor back "
                      "to the host (a device sync on CUDA)")
        # TS103: device-to-host copies
        if attr in ("cpu", "numpy") and recv_tensor:
            self.emit("TS103", node,
                      f"`.{attr}()` in the hot loop: a device-to-host copy "
                      "(the loop waits for the device on CUDA)")
        if attr == "to" and recv_tensor and any(
                _is_cpu(a) for a in list(args) + list(kw.values())):
            self.emit("TS103", node,
                      "`.to(\"cpu\")` in the hot loop: a device-to-host "
                      "copy (the loop waits for the device on CUDA)")
        root = fn
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id in self.np \
                and root.id not in self.env and any(
                    self.is_tensor(a) for a in list(args)
                    + list(kw.values())):
            self.emit("TS103", node,
                      "`np.*` on a tensor in the hot loop: copies it to "
                      "the host (a device sync on CUDA)")
        # TS106: syncs only torch has
        if attr in ("masked_fill", "masked_fill_", "index_fill",
                    "index_fill_"):
            pos = 1 if attr.startswith("masked") else 2
            if torch_call:
                pos += 1
            value = args[pos] if len(args) > pos else kw.get("value")
            if value is not None and self.is_tensor(value):
                self.emit("TS106", node,
                          f"`{attr}` with a tensor value in the hot loop: "
                          "the value is read back as a Python scalar (a "
                          "device sync on CUDA); use torch.where")
        if attr in _DATA_SHAPED and (recv_tensor or torch_call):
            self.emit("TS106", node,
                      f"`{attr}` in the hot loop: its output shape depends "
                      "on the data, so the host waits to learn it (a "
                      "device sync on CUDA)")
        if attr == "where" and torch_call and len(args) == 1 \
                and not node.keywords:
            self.emit("TS106", node,
                      "one-argument `torch.where` in the hot loop: "
                      "`nonzero` in disguise (a device sync on CUDA)")
        if attr == "repeat_interleave" and (recv_tensor or torch_call) \
                and "output_size" not in kw:
            # the repeats: the receiver's first argument, or torch's second
            # (torch.repeat_interleave(r) repeats arange by r itself)
            pos = 1 if torch_call else 0
            reps = args[pos] if len(args) > pos else kw.get(
                "repeats", args[0] if torch_call and args else None)
            if reps is not None and self.is_tensor(reps):
                self.emit("TS106", node,
                          "`repeat_interleave` by a tensor of repeats "
                          "without `output_size` in the hot loop: the host "
                          "reads the repeats to size the output (a device "
                          "sync on CUDA)")

    def run(self) -> list:
        self.visit_FunctionDef(self.fn)
        self.final_state = dict(self.env)
        return list(self.findings.values())


def _is_meta(node) -> bool:
    """Whether an expression reads a tensor's metadata (``.shape``,
    ``.dtype``, ``.device``, ``.dim()``, ``.numel()``, ``len()``): a
    comparison with it is a Python bool."""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _HOST_ATTRS:
            return True
        if isinstance(n, ast.Call) and (
                (isinstance(n.func, ast.Attribute)
                 and n.func.attr in ("dim", "numel", "size"))
                or (isinstance(n.func, ast.Name) and n.func.id == "len")):
            return True
    return False


def _exits(body) -> bool:
    """Whether a block always leaves (return, raise, continue, break)."""
    return bool(body) and isinstance(body[-1], (ast.Return, ast.Raise,
                                                ast.Continue, ast.Break))


def _is_cpu(node) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0] == "cpu"
    if isinstance(node, ast.Call) and node.args:
        return _func_name(node.func) in ("torch.device", "device") \
            and _is_cpu(node.args[0])
    return False


# ---------------------------------------------------------------------------
# TS104: non-hashable captures in cache-keyed callables
# ---------------------------------------------------------------------------

_MUTABLE_NODES = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                  ast.SetComp)


def _check_cache_keyed(mod: Module) -> list:
    findings = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        for kw in node.keywords:
            if kw.arg not in _CACHE_KEYED_KWARGS:
                continue
            for f in _callables_in(kw.value, mod):
                findings += _mutable_captures(mod, f, kw.arg)
    return findings


def _callables_in(node, mod: Module):
    """Lambdas / resolvable function defs inside a sink argument."""
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Lambda):
            out.append(n)
        elif isinstance(n, ast.Name) and n.id in mod.functions:
            out.append(mod.functions[n.id])
    return out


def _mutable_captures(mod: Module, fn, sink: str) -> list:
    """Flag free variables of ``fn`` bound to list/dict/set literals in
    the module, and mutable default arguments."""
    findings = []
    args = fn.args
    params = {a.arg for a in list(args.args) + list(args.kwonlyargs)}
    body = fn.body if isinstance(fn.body, list) else [fn.body]
    local = set(params)
    for n in ast.walk(fn):
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            tgt = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in tgt:
                for nm in ast.walk(t):
                    if isinstance(nm, ast.Name):
                        local.add(nm.id)
    free = set()
    for stmt in body:
        for n in ast.walk(stmt):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id not in local:
                free.add(n.id)
    for d in list(args.defaults) + [d for d in args.kw_defaults if d]:
        if isinstance(d, _MUTABLE_NODES) \
                and "ts104" not in mod.suppressed(d.lineno):
            findings.append(Finding(
                rule="TS104", severity=ERROR, target=mod.name,
                path=mod.path, line=d.lineno,
                message=f"mutable default argument in a callable passed "
                        f"to cache-keyed sink `{sink}`: unhashable, or "
                        "aliases state across cached runs"))
    mutable_names = set()
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Assign) and isinstance(n.value,
                                                    _MUTABLE_NODES):
            for t in n.targets:
                if isinstance(t, ast.Name):
                    mutable_names.add(t.id)
    for nm in sorted(free & mutable_names):
        line = getattr(fn, "lineno", 0)
        if "ts104" in mod.suppressed(line):
            continue
        findings.append(Finding(
            rule="TS104", severity=ERROR, target=mod.name, path=mod.path,
            line=line,
            message=f"callable passed to cache-keyed sink `{sink}` "
                    f"captures `{nm}`, which is bound to a mutable "
                    "list/dict/set: the RunCache freezes closures by value "
                    "and mutables are unhashable"))
    return findings


# ---------------------------------------------------------------------------
# TS105: the port's import rule
# ---------------------------------------------------------------------------

def _check_imports(mod: Module) -> list:
    out = []
    for line, name in mod.imported_modules():
        top = name.split(".")[0]
        if top in FOREIGN and "ts105" not in mod.suppressed(line):
            out.append(Finding(
                rule="TS105", severity=ERROR, target=mod.name,
                path=mod.path, line=line,
                message=f"imports `{name}`: the port runs on torch alone "
                        "and imports nothing of JAX or of the reference "
                        "package"))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def lint_paths(paths, root: str | None = None) -> LintReport:
    """Run the host-sync pass over files/directories.  ``meta`` holds
    the number of ``modules``, the hot ``traced_contexts`` (the loop
    roots first, as ``module:qualname``) and the per-line
    ``suppressions`` (``path:line [rules]``)."""
    modules = load_modules(paths, root=root)
    report = LintReport(target="host-sync", meta={
        "modules": len(modules),
        "paths": [str(p) for p in paths]})
    index = ContextIndex(modules)
    report.meta["traced_contexts"] = sorted(
        f"{m}:{q}" for (m, q) in index.roots) + sorted(
        f"{m}:{q}" for (m, q) in index.contexts
        if (m, q) not in index.roots)
    report.meta["suppressions"] = [
        f"{mod.path}:{line} [{','.join(rules)}]"
        for mod in modules.values() if not mod.skip_file()
        for line, rules in mod.suppressions()]

    for mod in modules.values():
        if mod.skip_file():
            continue
        report.extend(_check_imports(mod))
        report.extend(_check_cache_keyed(mod))

    proj = _Project(modules, index)
    todo = [(k, loops) for k, loops in sorted(index.roots.items())] + [
        (k, True) for k in sorted(index.contexts) if k not in index.roots]
    for (mname, qual), hot_nodes in todo:
        mod = modules[mname]
        if mod.skip_file():
            continue
        report.extend(_FunctionLint(proj, mod, qual, hot_nodes).run())
    return report


def package_dir() -> str:
    """The directory of the installed ``repro_torch`` package."""
    import repro_torch
    return os.path.dirname(os.path.abspath(repro_torch.__file__))


def lint_package() -> LintReport:
    """Lint the installed ``repro_torch`` tree."""
    return lint_paths([package_dir()])
