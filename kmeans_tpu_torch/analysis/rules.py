"""The rule registry: one rule per hand-enforced incident class.

Counterpart of ``kmeans_tpu/analysis/rules.py``, with the same 17 rule ids,
invariants and incident citations.  The rules that read plain Python
shared by both packages (``thread``, ``counter-reset``, ``dead-private``,
``cache-name``, ``quality-counter``, ``fleet-record``, ``atomic-swap``,
``suppression``) are the reference's, with the port's names where they
differ.  The others match the port's torch idioms in place of the JAX
ones; each one's docstring names the reference lines it replaces.

Each rule is an ``ast``-level check with an ``id``, a one-line
``incident`` citation (the historical review finding it mechanizes),
and a ``run(package) -> [Finding]``.  Rules never import the modules
they inspect.
"""

from __future__ import annotations

import ast
import builtins
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from kmeans_tpu_torch.analysis.core import Finding, Module, Package

_BUILTINS = set(dir(builtins))


# ------------------------------------------------------------ helpers

def dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain rooted at a Name, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _leaf(node: ast.AST) -> str:
    return (dotted(node) or "").split(".")[-1]


def _value_paths(node: ast.AST) -> Set[str]:
    """Every maximal Name/Attribute dotted path loaded anywhere inside
    ``node`` (including within calls/subscripts)."""
    paths: Set[str] = set()

    class V(ast.NodeVisitor):
        def visit_Attribute(self, n):
            p = dotted(n)
            if p is not None:
                paths.add(p)
            else:
                self.generic_visit(n)

        def visit_Name(self, n):
            paths.add(n.id)

    V().visit(node)
    return paths


def _bound_in(node: ast.AST) -> Set[str]:
    """Names bound inside ``node``: lambda/def params, comprehension
    targets, assignments, with/except/for targets."""
    bound: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, (ast.Lambda, ast.FunctionDef,
                          ast.AsyncFunctionDef)):
            a = n.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs
                        + ([a.vararg] if a.vararg else [])
                        + ([a.kwarg] if a.kwarg else [])):
                bound.add(arg.arg)
        elif isinstance(n, ast.comprehension):
            for t in ast.walk(n.target):
                if isinstance(t, ast.Name):
                    bound.add(t.id)
        elif isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store):
            bound.add(n.id)
        elif isinstance(n, ast.ExceptHandler) and n.name:
            bound.add(n.name)
    return bound


def _func_params(fn) -> Set[str]:
    a = fn.args
    return {arg.arg for arg in (a.posonlyargs + a.args + a.kwonlyargs
                                + ([a.vararg] if a.vararg else [])
                                + ([a.kwarg] if a.kwarg else []))}


def _import_names(mod: Module) -> Set[str]:
    """Names bound by an import anywhere in the module: static module
    references, never a tensor and never a knob."""
    names: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                names.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            for alias in node.names:
                names.add(alias.asname or alias.name)
    return names


def _local_def(mod: Module, at: ast.AST, name: str):
    """The ``def name`` nested in a function that encloses ``at`` (the
    nearest one), or None: a local function, made anew at each call of
    its enclosing function."""
    fn = mod.enclosing(at, (ast.FunctionDef, ast.AsyncFunctionDef))
    while fn is not None:
        for node in ast.walk(fn):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn and node.name == name:
                return node
        fn = mod.enclosing(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
    return None


def _driver_functions(mod: Module):
    """Module-level functions and class methods: the 'driver-level'
    functions the span rules check (a nested closure is checked through
    the enclosing driver's subtree walk)."""
    parents = mod.parents()
    for fn in ast.walk(mod.tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and isinstance(parents.get(fn), (ast.Module, ast.ClassDef)):
            yield fn


def _scoped(mod: Module, *segments: str) -> bool:
    p = mod.rel.replace("\\", "/")
    return any(s in p for s in segments)


class Rule:
    id: str = ""
    incident: str = ""

    def run(self, pkg: Package) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, mod: Module, line: int, message: str) -> Finding:
        return Finding(rule=self.id, path=mod.rel, line=line,
                       message=message, incident=self.incident)


# ------------------------------------------------------- trace-hazard

#: The base class of the device loops whose ``iterate()`` is captured as
#: a CUDA graph (``parallel/distributed.py`` ``_Replay``).
_REPLAY_BASES = {"_Replay"}
_LOOP_METHOD = "iterate"
#: Host-cast calls that force a device value to Python: a host sync, and
#: a constant frozen into the graph at capture time.
_HOST_CASTS = {"float", "int", "bool"}
_HOST_FUNCS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
               "onp.asarray", "onp.array"}
_SYNC_FUNCS = {"torch.cuda.synchronize"}
_NONZERO_FUNCS = {"torch.nonzero"}
#: Tensor methods that copy device memory to the host and wait for it.
_HOST_READ_METHODS = {"item", "cpu", "tolist", "numpy"}
#: Attribute leaves whose value is fixed when the graph is captured.
_STATIC_LEAVES = {"shape", "ndim", "size", "numel", "dim", "dtype",
                  "device", "is_cuda"}
#: ``torch.*`` calls that make no tensor.
_NON_TENSOR_TORCH = {"device", "dtype", "Size", "is_tensor", "finfo",
                     "iinfo", "get_default_dtype", "is_floating_point",
                     "Generator", "is_grad_enabled"}
#: Calls whose value reads no tensor element (a test through them is
#: static).
_STATIC_CALLS = {"isinstance", "len", "hasattr", "callable", "getattr",
                 "type", "id"}


def _class_index(pkg: Package) -> Dict[str, List[Tuple[Module,
                                                        ast.ClassDef]]]:
    out: Dict[str, List[Tuple[Module, ast.ClassDef]]] = {}
    for mod in pkg:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                out.setdefault(node.name, []).append((mod, node))
    return out


def _annotation_is_static(arg: ast.arg) -> bool:
    """A parameter annotated with a type that is not a tensor (``str``,
    ``int``, ``Optional[float]`` ...) is a static knob; an unannotated one
    may be a tensor."""
    if arg.annotation is None:
        return False
    return "Tensor" not in ast.unparse(arg.annotation)


class TraceHazardRule(Rule):
    """Host-Python operations inside the bodies a CUDA graph captures, in
    the compiled layers (``parallel/``, ``ops/``).  Replaces the
    reference's ``lax.scan``/``while_loop``/``fori_loop``/``cond`` bodies
    (``kmeans_tpu/analysis/rules.py:96-235``): the port's compiled bodies
    are

    * the ``iterate`` method of every ``_Replay`` subclass (the device
      loops, whose iteration ``_Replay._capture`` records into a CUDA
      graph and replays; ``_Replay``'s contract: ``iterate()`` reads
      nothing to the host);
    * every statement inside a ``with torch.cuda.graph(...)`` block;
    * every function such a body calls, resolved in the same module:
      ``self.m()`` to the methods ``m`` of the class's hierarchy, ``f()``
      to the local or module-level ``def f``, ``obj.m()`` to the methods
      ``m`` of the module's classes.

    Flagged inside one: ``.item()``, ``.cpu()``, ``.tolist()``,
    ``.numpy()``; ``float()``/``int()``/``bool()`` of anything but a
    shape, ``ndim``, ``numel()``/``size()`` or ``len()``; ``np.asarray``,
    ``np.array``; ``torch.cuda.synchronize``; ``.nonzero()`` and
    ``torch.nonzero`` (an output sized by the data); a Python ``while``;
    and an ``if`` whose test reads a tensor.

    What reads a tensor: the body's own parameters (unless annotated with
    a non-tensor type), the locals it assigns from a tensor expression,
    and the ``self.<attr>`` the class (or a base) assigns from one — a
    ``torch.*`` call, a tensor read, a ``Tensor``-annotated or unannotated
    parameter.  An attribute assigned only from constants or from
    ``str``/``int``/``float``/``bool``-annotated parameters is a static
    knob, fixed for the graph's life; so are shapes, ``dtype``, ``device``
    and identity tests (``x is None``)."""

    id = "trace-hazard"
    incident = ("would recompile or fail under trace — the class the "
                "host_loop=False device loops exist to forbid")

    def run(self, pkg: Package) -> Iterator[Finding]:
        classes = _class_index(pkg)
        replay = self._replay_classes(classes)
        for mod in pkg:
            if not _scoped(mod, "/parallel/", "/ops/"):
                continue
            yield from self._check_module(mod, classes, replay)

    @staticmethod
    def _replay_classes(classes) -> Set[str]:
        names = set(_REPLAY_BASES)
        grew = True
        while grew:
            grew = False
            for name, defs in classes.items():
                if name in names:
                    continue
                if any(_leaf(b) in names for _, c in defs for b in c.bases):
                    names.add(name)
                    grew = True
        return names

    # ----------------------------------------------------- class model
    def _hierarchy(self, cls: ast.ClassDef, classes) -> List[ast.ClassDef]:
        """``cls``, its in-package bases and its in-package subclasses
        (transitively): where ``self.m`` may resolve."""
        out = [cls]
        seen = {id(cls)}
        todo = [cls]
        while todo:
            c = todo.pop()
            for b in c.bases:
                for _, bc in classes.get(_leaf(b), []):
                    if id(bc) not in seen:
                        seen.add(id(bc))
                        out.append(bc)
                        todo.append(bc)
            for defs in classes.values():
                for _, sc in defs:
                    if id(sc) not in seen and any(
                            _leaf(b) == c.name for b in sc.bases):
                        seen.add(id(sc))
                        out.append(sc)
                        todo.append(sc)
        return out

    def _bases(self, cls: ast.ClassDef, classes) -> List[ast.ClassDef]:
        out, todo, seen = [cls], [cls], {id(cls)}
        while todo:
            c = todo.pop()
            for b in c.bases:
                for _, bc in classes.get(_leaf(b), []):
                    if id(bc) not in seen:
                        seen.add(id(bc))
                        out.append(bc)
                        todo.append(bc)
        return out

    def _tensor_attrs(self, cls: ast.ClassDef, classes) -> Set[str]:
        """The ``self.<attr>`` of ``cls`` and its bases that hold tensors."""
        attrs: Set[str] = set()
        for c in self._bases(cls, classes):
            for method in c.body:
                if isinstance(method, ast.FunctionDef):
                    names = self._tensor_names(method, True, set())
                    for node in ast.walk(method):
                        self._attr_stores(node, names, attrs)
        return attrs

    def _attr_stores(self, node, names: Set[str], attrs: Set[str]) -> None:
        if isinstance(node, ast.AnnAssign):
            t = node.target
            if dotted(t) is not None and dotted(t).startswith("self.") \
                    and dotted(t).count(".") == 1:
                if "Tensor" in ast.unparse(node.annotation) or (
                        node.value is not None
                        and self._tensorish(node.value, names, attrs)):
                    attrs.add(t.attr)
            return
        if not isinstance(node, ast.Assign):
            return
        for t in node.targets:
            pairs = self._pairs(t, node.value)
            for tgt, val in pairs:
                p = dotted(tgt)
                if p is not None and p.startswith("self.") \
                        and p.count(".") == 1 \
                        and self._tensorish(val, names, attrs):
                    attrs.add(tgt.attr)

    @staticmethod
    def _pairs(target, value):
        if isinstance(target, (ast.Tuple, ast.List)) and isinstance(
                value, (ast.Tuple, ast.List)) \
                and len(target.elts) == len(value.elts):
            return list(zip(target.elts, value.elts))
        if isinstance(target, (ast.Tuple, ast.List)):
            return [(t, value) for t in target.elts]
        return [(target, value)]

    def _tensor_names(self, fn, is_method: bool,
                      attrs: Set[str]) -> Set[str]:
        """Parameters and locals of ``fn`` that may hold tensors."""
        a = fn.args
        params = a.posonlyargs + a.args
        if is_method and params:
            params = params[1:]
        names = {p.arg for p in params + a.kwonlyargs
                 if not _annotation_is_static(p)}
        for extra in (a.vararg, a.kwarg):
            if extra is not None:
                names.add(extra.arg)
        for _ in range(2):                   # assignments feed each other
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        for tgt, val in self._pairs(t, node.value):
                            if isinstance(tgt, ast.Name) \
                                    and self._tensorish(val, names, attrs):
                                names.add(tgt.id)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    if self._tensorish(node.iter, names, attrs):
                        for t in ast.walk(node.target):
                            if isinstance(t, ast.Name):
                                names.add(t.id)
        return names

    def _tensorish(self, expr, names: Set[str], attrs: Set[str]) -> bool:
        if isinstance(expr, ast.Call) and dotted(expr.func) in (
                _HOST_CASTS | {"str", "len"}):
            return False                     # a Python value
        for n in ast.walk(expr):
            if isinstance(n, ast.Call):
                parts = (dotted(n.func) or "").split(".")
                if parts[0] == "torch" and len(parts) > 1 \
                        and parts[1] != "cuda" \
                        and parts[-1] not in _NON_TENSOR_TORCH:
                    return True
        return bool(self._tensor_reads(expr, names, attrs))

    @staticmethod
    def _tensor_reads(expr, names: Set[str], attrs: Set[str]) -> Set[str]:
        """The tensors ``expr`` reads element values of: a tainted name or
        tensor attribute, not through a static leaf (shape, dtype ...),
        an identity test or a static call (``isinstance``, ``len``)."""
        found: Set[str] = set()

        def visit(n):
            if isinstance(n, ast.Compare) and all(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
                return
            if isinstance(n, ast.Call) and dotted(n.func) in _STATIC_CALLS:
                return
            if isinstance(n, (ast.Attribute, ast.Name)):
                p = dotted(n)
                if p is not None:
                    parts = p.split(".")
                    if any(x in _STATIC_LEAVES for x in parts[1:]):
                        return
                    if parts[0] in names:
                        found.add(parts[0])
                    elif parts[0] == "self" and len(parts) > 1 \
                            and parts[1] in attrs:
                        found.add(f"self.{parts[1]}")
                    return
            for child in ast.iter_child_nodes(n):
                visit(child)

        visit(expr)
        return found

    # ------------------------------------------------------ resolution
    def _resolve(self, mod: Module, call: ast.Call, cls, classes,
                 mod_classes, imports) -> List[tuple]:
        """The module's functions a call inside a compiled body may run:
        (FunctionDef, owning ClassDef or None)."""
        func = call.func
        out: List[tuple] = []
        if isinstance(func, ast.Name):
            local = _local_def(mod, call, func.id)
            if local is not None:
                return [(local, None)]
            for node in mod.tree.body:
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and node.name == func.id:
                    out.append((node, None))
            return out
        if not isinstance(func, ast.Attribute):
            return out
        path = dotted(func)
        if isinstance(func.value, ast.Name) and func.value.id == "self":
            pool = [c for c in self._hierarchy(cls, classes)
                    if any(c is mc for mc in mod_classes)] \
                if cls is not None else []
        elif path is not None and path.split(".")[0] in imports:
            return out
        else:
            pool = self._receiver_classes(mod, call, cls, mod_classes) \
                or mod_classes
        for c in pool:
            for m in c.body:
                if isinstance(m, ast.FunctionDef) and m.name == func.attr:
                    out.append((m, c))
        return out

    @staticmethod
    def _receiver_classes(mod: Module, call: ast.Call, cls,
                          mod_classes) -> List[ast.ClassDef]:
        """The module's classes the receiver of ``obj.m()`` is made from,
        where the source says: ``self.<attr>`` (or a loop variable over
        it) assigned from calls of those classes in ``cls``.  Empty when
        unknown (then every class of the module is a candidate)."""
        recv = call.func.value
        attr = None
        if isinstance(recv, ast.Attribute) and dotted(recv) is not None \
                and dotted(recv).count(".") == 1 \
                and dotted(recv).startswith("self."):
            attr = recv.attr
        elif isinstance(recv, ast.Name):
            fn = mod.enclosing(call, (ast.FunctionDef, ast.AsyncFunctionDef))
            for node in ast.walk(fn) if fn is not None else ():
                if isinstance(node, ast.For) \
                        and isinstance(node.target, ast.Name) \
                        and node.target.id == recv.id:
                    p = dotted(node.iter) or ""
                    if p.startswith("self.") and p.count(".") == 1:
                        attr = p.split(".")[1]
        if attr is None or cls is None:
            return []
        names = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and any(
                    dotted(t) == f"self.{attr}" for t in node.targets):
                for n in ast.walk(node.value):
                    if isinstance(n, ast.Call) \
                            and isinstance(n.func, ast.Name):
                        names.add(n.func.id)
        return [c for c in mod_classes if c.name in names]

    @staticmethod
    def _graph_blocks(mod: Module):
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    p = dotted(expr.func) or ""
                    if p.startswith("torch") and p.endswith(".graph"):
                        yield node
                        break

    def _check_module(self, mod: Module, classes, replay) -> Iterator[
            Finding]:
        mod_classes = [n for n in ast.walk(mod.tree)
                       if isinstance(n, ast.ClassDef)]
        imports = _import_names(mod)
        owner = {}
        for c in mod_classes:
            for m in c.body:
                if isinstance(m, ast.FunctionDef):
                    owner[id(m)] = c
        todo: List[tuple] = []
        for c in mod_classes:
            if c.name in replay:
                for m in c.body:
                    if isinstance(m, ast.FunctionDef) \
                            and m.name == _LOOP_METHOD:
                        todo.append((m, c))
        blocks = list(self._graph_blocks(mod))
        for block in blocks:
            cls = mod.enclosing(block, (ast.ClassDef,))
            for stmt in block.body:
                for n in ast.walk(stmt):
                    if isinstance(n, ast.Call):
                        todo.extend(self._resolve(mod, n, cls, classes,
                                                  mod_classes, imports))
        done: Dict[int, tuple] = {}
        while todo:
            fn, cls = todo.pop()
            if id(fn) in done:
                continue
            cls = cls if cls is not None else owner.get(id(fn))
            done[id(fn)] = (fn, cls)
            for n in ast.walk(fn):
                if isinstance(n, ast.Call):
                    todo.extend(self._resolve(mod, n, cls, classes,
                                              mod_classes, imports))
        seen: Set[tuple] = set()
        for fn, cls in sorted(done.values(), key=lambda e: e[0].lineno):
            attrs = self._tensor_attrs(cls, classes) if cls else set()
            names = self._tensor_names(fn, owner.get(id(fn)) is not None,
                                       attrs)
            for stmt in fn.body:
                for f in self._check_node(mod, stmt, names, attrs):
                    if (f.line, f.message) not in seen:
                        seen.add((f.line, f.message))
                        yield f
        for block in blocks:
            fn = mod.enclosing(block, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
            cls = mod.enclosing(block, (ast.ClassDef,))
            attrs = self._tensor_attrs(cls, classes) if cls else set()
            names = self._tensor_names(fn, owner.get(id(fn)) is not None,
                                       attrs) if fn is not None else set()
            for stmt in block.body:
                for f in self._check_node(mod, stmt, names, attrs):
                    if (f.line, f.message) not in seen:
                        seen.add((f.line, f.message))
                        yield f

    # ------------------------------------------------------------ body
    def _check_node(self, mod: Module, node: ast.AST, names: Set[str],
                    attrs: Set[str]) -> Iterator[Finding]:
        """Scoped walk: a nested def/lambda's params join the tensor set
        only FOR ITS OWN SUBTREE (a sibling's ``c`` must not taint the
        outer scope)."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            inner = names | {p for p in _func_params(node)}
            for child in node.body:
                yield from self._check_node(mod, child, inner, attrs)
            return
        if isinstance(node, ast.Lambda):
            yield from self._check_node(
                mod, node.body, names | _func_params(node), attrs)
            return
        yield from self._flag_node(mod, node, names, attrs)
        for child in ast.iter_child_nodes(node):
            yield from self._check_node(mod, child, names, attrs)

    def _flag_node(self, mod: Module, node: ast.AST, names: Set[str],
                   attrs: Set[str]) -> Iterator[Finding]:
        if isinstance(node, ast.Call):
            path = dotted(node.func)
            attr = node.func.attr if isinstance(node.func,
                                                ast.Attribute) else None
            if path in _HOST_CASTS and node.args and not (
                    isinstance(node.args[0], ast.Constant)
                    or self._is_static(node.args[0])):
                yield self.finding(
                    mod, node.lineno,
                    f"host cast {path}() on a value inside a CUDA-graph "
                    f"captured body (a host sync, and a constant frozen "
                    f"into the graph)")
            elif path in _HOST_FUNCS:
                yield self.finding(
                    mod, node.lineno,
                    f"{path}() materializes a device value to host "
                    f"inside a CUDA-graph captured body")
            elif path in _SYNC_FUNCS:
                yield self.finding(
                    mod, node.lineno,
                    f"{path}() inside a CUDA-graph captured body (a "
                    f"capture cannot wait for the host)")
            elif path in _NONZERO_FUNCS or attr == "nonzero":
                yield self.finding(
                    mod, node.lineno,
                    "nonzero() sizes its output by the data: a host sync "
                    "inside a CUDA-graph captured body")
            elif attr in _HOST_READ_METHODS:
                yield self.finding(
                    mod, node.lineno,
                    f".{attr}() forces a host sync inside a CUDA-graph "
                    f"captured body")
        elif isinstance(node, ast.While):
            yield self.finding(
                mod, node.lineno,
                "Python while-loop inside a CUDA-graph captured body (the "
                "trip count must stay on the device: mask the iteration "
                "by a flag tensor)")
        elif isinstance(node, (ast.If, ast.IfExp)):
            tainted = sorted(self._tensor_reads(node.test, names, attrs))
            if tainted:
                yield self.finding(
                    mod, node.lineno,
                    f"Python branch on tensor {', '.join(tainted)} inside "
                    f"a CUDA-graph captured body (use torch.where)")

    @staticmethod
    def _is_static(node: ast.AST) -> bool:
        """Casts of shapes, element counts and lengths are static when the
        graph is captured."""
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute) and n.attr in ("shape",
                                                           "ndim", "size"):
                return True
            if isinstance(n, ast.Call) and (
                    dotted(n.func) == "len"
                    or (isinstance(n.func, ast.Attribute)
                        and n.func.attr in ("numel", "size", "dim"))):
                return True
        return False


# ---------------------------------------------------------- cache-key

#: The port's build-through-cache helpers: their arguments become the
#: cache key by ``utils.cache.builder_key``.
_BUILD_HELPERS = {"_cached", "cached_build"}
#: Memo tables owned by their receiver (``Dataset.memo``,
#: ``ServingEngine._fn``): the owner's own state is keyed by its identity.
_MEMO_METHODS = {"memo", "_fn"}


class CacheKeyRule(Rule):
    """Every keyed factory of the port: each free variable the factory
    closes over (a local knob of the enclosing function — not a module
    global) must appear in the key, else two distinct knob values collide
    on one entry (wrong program or loop served) or salt-free twins build
    twice.  Replaces ``kmeans_tpu/analysis/rules.py:237-341``
    (``*_CACHE.get_or_create`` only).  The sites:

    * every ``.get_or_create(key, factory)``.  A key
      ``builder_key(f, *a, **kw)`` with the factory ``lambda: f(*a,
      **kw)`` (``utils.cache.cached_build``) is covered by construction;
    * every ``.memo(key, make)`` (``Dataset.memo``) and
      ``self._fn(key, make)`` (``ServingEngine._fn``).  These tables live
      on their receiver, so paths rooted at the receiver (``self.mesh``
      for the engine, ``ds.points`` for a dataset's memo) are covered by
      its identity; every other knob must be in the key;
    * every ``_cached(...)``/``cached_build(...)`` whose arguments hold a
      lambda or a function defined in the enclosing function:
      ``builder_key`` keys those by identity, so the entry is rebuilt at
      each call (or a stale closure is served).

    A factory named by a local ``def`` is audited through that def's own
    free variables.  A key held in a variable is chased to its nearest
    preceding assignment in the same function."""

    id = "cache-key"
    incident = ("r13 duplicate-compile class: predict_fn cached "
                "pipeline-free; serving score_rows key missing "
                "value_mode")

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            module_names = mod.module_scope_names()
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                func = node.func
                if any(isinstance(a, ast.Starred) for a in node.args):
                    continue
                if isinstance(func, ast.Attribute) \
                        and func.attr == "get_or_create" \
                        and len(node.args) >= 2:
                    yield from self._check_site(mod, node, module_names,
                                                owner=None)
                elif isinstance(func, ast.Attribute) \
                        and func.attr in _MEMO_METHODS \
                        and len(node.args) == 2 \
                        and (func.attr == "memo"
                             or dotted(func) == "self._fn"):
                    root = (dotted(func.value) or "").split(".")[0]
                    yield from self._check_site(mod, node, module_names,
                                                owner=root or None)
                elif _leaf(func) in _BUILD_HELPERS:
                    yield from self._check_build(mod, node)

    def _check_build(self, mod: Module, call: ast.Call) -> Iterator[
            Finding]:
        leaf = _leaf(call.func)
        args = list(call.args[1:] if leaf == "cached_build"
                    else call.args) + [k.value for k in call.keywords]
        for arg in args:
            for n in ast.walk(arg):
                what = None
                if isinstance(n, ast.Lambda):
                    what = "a lambda"
                elif isinstance(n, ast.Name) \
                        and _local_def(mod, call, n.id) is not None:
                    what = f"the local function {n.id}"
                if what is not None:
                    yield self.finding(
                        mod, call.lineno,
                        f"{leaf}() is given {what}: builder_key keys it by "
                        f"identity, so the entry is rebuilt at every call "
                        f"or serves a stale closure — pass the knobs it "
                        f"closes over instead")
                    return

    def _check_site(self, mod: Module, call: ast.Call,
                    module_names: Set[str],
                    owner: Optional[str]) -> Iterator[Finding]:
        key_expr = self._resolve_key(mod, call, call.args[0])
        if key_expr is None:
            yield self.finding(
                mod, call.lineno,
                "cache key is not a tuple literal resolvable in this "
                "function — the key/knob audit cannot run")
            return
        factory = call.args[1]
        if self._blessed(key_expr, factory):
            return
        key_paths = _value_paths(key_expr)
        if isinstance(factory, ast.Lambda):
            body, bound = factory.body, _bound_in(factory)
        elif isinstance(factory, ast.Name) \
                and _local_def(mod, call, factory.id) is not None:
            local = _local_def(mod, call, factory.id)
            body = ast.Module(body=local.body, type_ignores=[])
            bound = _bound_in(local)
        else:
            body, bound = factory, _bound_in(factory)
        knobs = self._free_knobs(body, bound, module_names)
        missing = sorted(k for k in knobs
                         if not self._covered(k, key_paths)
                         and (owner is None or k.split(".")[0] != owner))
        if missing:
            yield self.finding(
                mod, call.lineno,
                f"factory closes over {', '.join(missing)} but the "
                f"cache key does not include "
                f"{'it' if len(missing) == 1 else 'them'} — distinct "
                f"values would collide on one compiled entry")

    @staticmethod
    def _blessed(key: ast.AST, factory: ast.AST) -> bool:
        """``builder_key(f, *a, **kw)`` keying ``lambda: f(*a, **kw)``:
        the key is the factory's whole call."""
        if not (isinstance(key, ast.Call) and _leaf(key.func)
                == "builder_key" and key.args
                and isinstance(factory, ast.Lambda)
                and isinstance(factory.body, ast.Call)):
            return False
        body = factory.body
        same = ast.dump(key.args[0]) == ast.dump(body.func)
        return same and [ast.dump(a) for a in key.args[1:]] == \
            [ast.dump(a) for a in body.args] and \
            [ast.dump(k) for k in key.keywords] == \
            [ast.dump(k) for k in body.keywords]

    @staticmethod
    def _resolve_key(mod: Module, call: ast.Call,
                     key: ast.AST) -> Optional[ast.AST]:
        """A tuple/constant key (or a ``builder_key(...)`` call) is used
        directly; a ``key`` variable is chased to its nearest preceding
        assignment of one in the same function."""
        def usable(node):
            return isinstance(node, (ast.Tuple, ast.Constant)) or (
                isinstance(node, ast.Call)
                and _leaf(node.func) == "builder_key")

        if usable(key):
            return key
        if not isinstance(key, ast.Name):
            return None
        fn = mod.enclosing(call, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda))
        if fn is None or isinstance(fn, ast.Lambda):
            return None
        best = None
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == key.id
                    and node.lineno <= call.lineno):
                if best is None or node.lineno > best.lineno:
                    best = node
        if best is not None and usable(best.value):
            return best.value
        return None

    @staticmethod
    def _free_knobs(body: ast.AST, bound: Set[str],
                    module_names: Set[str]) -> Set[str]:
        """Dotted paths in the factory whose root is neither bound in
        the factory, a module-scope name, nor a builtin — i.e. the
        closure's captured locals: the knobs."""
        knobs: Set[str] = set()
        for path in _value_paths(body):
            root = path.split(".")[0]
            if root in bound or root in module_names \
                    or root in _BUILTINS:
                continue
            knobs.add(path)
        return knobs

    @staticmethod
    def _covered(knob: str, key_paths: Set[str]) -> bool:
        """A knob is covered when the key carries it or any prefix of
        it (keying on ``self.mesh`` covers ``self.mesh.devices``)."""
        parts = knob.split(".")
        return any(".".join(parts[:i]) in key_paths
                   for i in range(1, len(parts) + 1))


# ----------------------------------------------------------- dispatch

class DispatchAccountingRule(Rule):
    """In ``serving/`` and ``parallel/``: a function that *calls* a
    compiled function must account the dispatch, so dispatch-count pins
    and serving stats stay honest as call sites are added.  Replaces
    ``kmeans_tpu/analysis/rules.py:343-432``: in the port a compiled
    function comes from ``get_or_create``, ``_cached``, ``cached_build``,
    ``.memo``, ``self._fn`` or ``_predict_fn``; the accounting is
    ``note_dispatch(...)`` (``utils/profiling.py``), ``._record(...)``, a
    ``dispatch``-named counter update, or ``_build.count_launch``."""

    id = "dispatch"
    incident = ("the O(1)-dispatch pins (ISSUE 2/7) and serving stats "
                "only hold if every compiled call site is tagged")

    _SOURCES = {"get_or_create", "_cached", "cached_build", "memo", "_fn",
                "_predict_fn"}
    _ACCOUNTING = ("note_dispatch", "_record", "count_launch")

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            if not _scoped(mod, "/serving/", "/parallel/"):
                continue
            for fn in ast.walk(mod.tree):
                if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from self._check_function(mod, fn)

    def _is_source_call(self, node: ast.AST) -> bool:
        """Does this expression produce a compiled function?"""
        for n in ast.walk(node):
            if isinstance(n, ast.Call):
                if _leaf(n.func) in self._SOURCES:
                    return True
        return False

    def _compiled_call_sites(self, fn) -> List[ast.Call]:
        """Invocations of compiled functions inside ``fn``: direct
        invokes of a ``_SOURCES`` result (``self._predict_fn(...)(...)``,
        ``self._fn(...)(...)``) and calls through a name a ``_SOURCES``
        call was assigned to.  Shared with :class:`ObsSpanRule` — ONE
        detection heuristic, two rules (dispatch accounting + span
        coverage), so the definition of "a compiled call site" can never
        drift between them."""
        compiled_names: Set[str] = set()
        sites: List[ast.Call] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) \
                    and self._is_source_call(node.value):
                for t in node.targets:
                    for leaf in ast.walk(t):
                        if isinstance(leaf, ast.Name):
                            compiled_names.add(leaf.id)
            if isinstance(node, ast.Call):
                if isinstance(node.func, (ast.Call, ast.Subscript)) \
                        and self._is_source_call(node.func):
                    sites.append(node)
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in compiled_names:
                    sites.append(node)
        return sites

    @classmethod
    def _has_accounting(cls, fn) -> bool:
        """Does ``fn`` tag a dispatch anywhere — ``note_dispatch(...)``,
        ``._record(...)``, ``count_launch(...)``, or a ``dispatch``-named
        counter update?  The ONE accounting predicate shared by the
        dispatch, obs-span and collective-span rules."""
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if _leaf(node.func) in cls._ACCOUNTING:
                    return True
            if isinstance(node, (ast.AugAssign, ast.Assign)):
                target = node.target if isinstance(node, ast.AugAssign) \
                    else (node.targets[0] if node.targets else None)
                if target is not None and "dispatch" in (
                        dotted(target) or "").lower():
                    return True
        return False

    def _check_function(self, mod: Module, fn) -> Iterator[Finding]:
        call_sites = self._compiled_call_sites(fn)
        # Functions that only BUILD and return the compiled fn (no
        # invocation) are accounted at their call sites instead.
        if call_sites and not self._has_accounting(fn):
            yield self.finding(
                mod, call_sites[0].lineno,
                f"{fn.name}() invokes a compiled function but never "
                f"tags the dispatch (note_dispatch/._record/dispatch "
                f"counter)")


# ----------------------------------------------------------- obs-span

class ObsSpanRule(DispatchAccountingRule):
    """Twin of the dispatch-accounting rule: in ``serving/`` and
    ``parallel/``, a driver-level function that invokes a compiled
    function must also run it under a telemetry span — a ``with``
    statement whose context manager is a ``span(...)`` call
    (``obs_trace.span``) somewhere in the function (``span()`` is the
    no-op fast path when tracing is off, so coverage costs nothing
    disabled).  Replaces ``kmeans_tpu/analysis/rules.py:435-495`` with the
    port's compiled-function sources (:class:`DispatchAccountingRule`)."""

    id = "obs-span"
    incident = ("ISSUE 11: a compiled dispatch invisible to the span "
                "timeline — the trace twin of the dispatch-counter "
                "class")

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            if not _scoped(mod, "/serving/", "/parallel/"):
                continue
            for fn in _driver_functions(mod):
                yield from self._check_spans(mod, fn)

    def _check_spans(self, mod: Module, fn) -> Iterator[Finding]:
        call_sites = self._compiled_call_sites(fn)
        if not call_sites:
            return
        if self._has_span(fn):
            return
        yield self.finding(
            mod, call_sites[0].lineno,
            f"{fn.name}() invokes a compiled function with no enclosing "
            f"telemetry span — wrap the dispatch in `with "
            f"obs_trace.span(...)` (a no-op when tracing is off) so it "
            f"appears on the trace timeline")

    @staticmethod
    def _has_span(fn) -> bool:
        for node in ast.walk(fn):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                expr = item.context_expr
                if isinstance(expr, ast.Call):
                    if _leaf(expr.func) in ("span", "tracing"):
                        return True
        return False


# ----------------------------------------------------- collective-span

#: torch.distributed collectives: host-side when run over a host (gloo)
#: group, in-graph over the mesh's device groups.
_TDIST_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
                      "broadcast", "reduce", "gather", "scatter",
                      "reduce_scatter", "reduce_scatter_tensor",
                      "all_to_all", "all_to_all_single"}
_OBJECT_COLLECTIVE = re.compile(
    r"^(all_gather|gather|broadcast|scatter)_object(_list)?$")


class CollectiveSpanRule(ObsSpanRule):
    """In ``parallel/``, a driver-level function that performs a
    HOST-SIDE cross-process collective — one that blocks every process in
    the fleet, invisible to the compiled-function rules — must run it
    under a telemetry span or carry a dispatch tag.  Replaces
    ``kmeans_tpu/analysis/rules.py:498-551`` (``process_allgather`` /
    ``sync_global_devices`` / ``broadcast_one_to_all``).  The port's host
    collectives: a ``barrier`` (``torch.distributed.barrier``,
    ``parallel/mesh.py`` ``barrier``), ``fleet_barrier``
    (``parallel/multihost.py``), every ``*_object`` collective, and a
    ``torch.distributed`` collective over a host group (its ``group=``
    made by a ``*host*`` helper, as ``gather_kshard_stats``'s gloo
    gather).  The in-graph ``all_reduce``s of a step run over the mesh's
    device groups and stay out, as the reference's psums do; so does the
    definition of a collective primitive itself (a function named
    ``barrier``): its callers are where the wait is spanned."""

    id = "collective-span"
    incident = ("ISSUE 13: a host-side collective invisible to the "
                "fleet timeline — the cross-process twin of the "
                "obs-span class")

    _COLLECTIVES = {"barrier", "fleet_barrier"}

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            if not _scoped(mod, "/parallel/"):
                continue
            for fn in _driver_functions(mod):
                if fn.name in self._COLLECTIVES:
                    continue
                sites = [node for node in ast.walk(fn)
                         if isinstance(node, ast.Call)
                         and self._is_collective(node)]
                if not sites:
                    continue
                if self._has_span(fn) or self._has_accounting(fn):
                    continue
                yield self.finding(
                    mod, sites[0].lineno,
                    f"{fn.name}() runs a host-side cross-process "
                    f"collective with no enclosing telemetry span or "
                    f"dispatch tag — wrap it in `with "
                    f"obs_trace.span('collective', ...)` (a no-op when "
                    f"tracing is off) so the fleet-blocking wait lands "
                    f"on the merged timeline")

    @classmethod
    def _is_collective(cls, call: ast.Call) -> bool:
        leaf = _leaf(call.func)
        if leaf in cls._COLLECTIVES or _OBJECT_COLLECTIVE.match(leaf):
            return True
        if leaf in _TDIST_COLLECTIVES:
            for kw in call.keywords:
                if kw.arg == "group" and isinstance(kw.value, ast.Call) \
                        and "host" in _leaf(kw.value.func).lower():
                    return True
        return False


# -------------------------------------------------------- ingest-span

class IngestSpanRule(ObsSpanRule):
    """In ``data/`` and ``parallel/sharding.py``, a driver-level function
    that PLACES host bytes on the device must run the placement under a
    ``stage``/``place`` telemetry span.  The time-to-first-iteration
    table's ``stage`` row and the per-slab ingest breakdown are built
    from those spans alone; a placement path without one silently
    undercounts ingest.  Replaces ``kmeans_tpu/analysis/rules.py:553-631``
    (``jax.device_put`` / ``make_array_from_*``): the port's placements
    are ``.to(<device>)`` (a positional or ``device=`` argument naming a
    device: a ``*device*``/``dev`` name, ``torch.device(...)`` or a
    ``'cuda...'`` string), ``.cuda()``, ``torch.as_tensor(...,
    device=)``/``torch.tensor(..., device=)``, and a ``.copy_`` from host
    memory (``non_blocking=True`` from a pinned buffer, or a
    ``torch.from_numpy`` source)."""

    id = "ingest-span"
    incident = ("ISSUE 18: a host->device placement invisible to the "
                "ingest timeline — the TTFI stage row silently "
                "undercounts; the placement twin of the obs-span class")

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            p = mod.rel.replace("\\", "/")
            if "/data/" not in p and not p.endswith(
                    "parallel/sharding.py"):
                continue
            for fn in _driver_functions(mod):
                sites = [node.lineno for node in ast.walk(fn)
                         if isinstance(node, ast.Call)
                         and self._is_placement(node)]
                if not sites:
                    continue
                if self._has_stage_span(fn):
                    continue
                yield self.finding(
                    mod, sites[0],
                    f"{fn.name}() places host bytes on device with no "
                    f"enclosing 'stage'/'place' span — wrap the "
                    f"placement in `with obs_trace.span('stage', "
                    f"rows=..., bytes=...)` (a no-op when tracing is "
                    f"off) so it lands on the ingest timeline and the "
                    f"TTFI stage row")

    @staticmethod
    def _names_device(node: ast.AST) -> bool:
        if isinstance(node, ast.Constant):
            return isinstance(node.value, str) \
                and node.value.startswith("cuda")
        if isinstance(node, ast.Call):
            return dotted(node.func) == "torch.device"
        leaf = _leaf(node).lower()
        return bool(leaf) and ("device" in leaf or leaf == "dev")

    @classmethod
    def _is_placement(cls, call: ast.Call) -> bool:
        func = call.func
        path = dotted(func) or ""
        device_kw = [k.value for k in call.keywords if k.arg == "device"]
        if isinstance(func, ast.Attribute) and func.attr == "to":
            return any(cls._names_device(a)
                       for a in list(call.args) + device_kw)
        if isinstance(func, ast.Attribute) and func.attr == "cuda":
            return not path.startswith("torch.")
        if path in ("torch.as_tensor", "torch.tensor"):
            return any(not (isinstance(v, ast.Constant) and v.value is None)
                       for v in device_kw)
        if isinstance(func, ast.Attribute) and func.attr == "copy_":
            if any(k.arg == "non_blocking" and isinstance(
                    k.value, ast.Constant) and k.value.value is True
                   for k in call.keywords):
                return True
            return any(isinstance(n, ast.Call)
                       and _leaf(n.func) == "from_numpy"
                       for a in call.args for n in ast.walk(a))
        return False

    @staticmethod
    def _has_stage_span(fn) -> bool:
        """Stricter than the parent's ``_has_span``: the span must be
        NAMED ``'stage'`` or ``'place'`` (a literal first argument) —
        an ingest placement filed under some other phase name would
        corrupt the TTFI decomposition rather than merely missing it."""
        for node in ast.walk(fn):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                expr = item.context_expr
                if not isinstance(expr, ast.Call):
                    continue
                if _leaf(expr.func) != "span":
                    continue
                if expr.args and isinstance(expr.args[0], ast.Constant) \
                        and expr.args[0].value in ("stage", "place"):
                    return True
        return False


# ------------------------------------------------------ quality-counter

class QualityCounterRule(ObsSpanRule):
    """A member of the obs-span lint family: in ``serving/``, a
    driver-level function that RECORDS serving traffic (calls the
    engine's ``._record`` stats recorder, or bumps the
    ``packed_dispatches`` counter — the packed path's accounting) must
    also feed the quality monitor (``._observe_quality``/
    ``.observe``).  A dispatch path that counts its traffic but skips
    the monitor silently starves the drift detectors of exactly that
    path's labels — the monitoring twin of the dispatch-counter
    incident class, and how a future fifth dispatch path would
    otherwise go blind.  The reference's rule
    (``kmeans_tpu/analysis/rules.py:635-705``), unchanged: the port's
    engine keeps its names."""

    id = "quality-counter"
    incident = ("ISSUE 14: a serving dispatch path recorded in the "
                "stats but invisible to the drift monitor — the "
                "quality twin of the dispatch-counter class")

    _FEEDS = {"_observe_quality", "observe"}

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            p = mod.rel.replace("\\", "/")
            if "/serving/" not in p:
                continue
            parents = mod.parents()
            for fn in ast.walk(mod.tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                # Driver-level only (the obs-span convention): nested
                # closures are checked through the enclosing driver.
                if not isinstance(parents.get(fn),
                                  (ast.Module, ast.ClassDef)):
                    continue
                sites = self._traffic_sites(fn)
                if not sites:
                    continue
                if self._feeds_monitor(fn):
                    continue
                yield self.finding(
                    mod, sites[0],
                    f"{fn.name}() records serving traffic but never "
                    f"feeds the quality monitor — call "
                    f"_observe_quality(...) with the labels/scores "
                    f"this dispatch already computed (a no-op when "
                    f"monitoring is off)")

    @staticmethod
    def _traffic_sites(fn) -> List[int]:
        """Lines where ``fn`` records serving traffic: ``._record(...)``
        calls and ``packed_dispatches`` counter INCREMENTS (AugAssign
        only — the ``= 0`` declarations in __init__ are bookkeeping
        setup, not traffic)."""
        lines: List[int] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if (dotted(node.func) or "").split(".")[-1] == "_record":
                    lines.append(node.lineno)
            elif isinstance(node, ast.AugAssign):
                if "packed_dispatches" in (dotted(node.target) or ""):
                    lines.append(node.lineno)
        return lines

    @classmethod
    def _feeds_monitor(cls, fn) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                if (dotted(node.func) or "").split(".")[-1] \
                        in cls._FEEDS:
                    return True
        return False


# -------------------------------------------------------- fleet-record

class FleetRecordRule(QualityCounterRule):
    """A member of the quality-counter lint family: in
    ``serving/``, a driver-level function that FORWARDS a request to a
    replica engine (``<...>.engine.call/submit/score/predict/
    predict_multi(...)``) or SHEDS one (``raise FleetOverloadError``)
    must record the decision in the metrics registry — call the
    fleet's ``_record_route``/``_record_shed`` write-throughs.  The
    router's routing and admission decisions ARE the SLO signal
    (``fleet.route``/``fleet.shed`` counters, the scaling-curve
    denominators); a future routing path that forwards or sheds
    without recording silently starves that signal exactly the way
    unrecorded dispatch paths used to starve the dispatch counters.  The
    reference's rule (``kmeans_tpu/analysis/rules.py:708-779``),
    unchanged: the port's fleet keeps its names."""

    id = "fleet-record"
    incident = ("ISSUE 17: a fleet routing path that forwards or sheds "
                "without recording — the router twin of the "
                "dispatch-counter class")

    _FEEDS = {"_record_route", "_record_shed"}
    _FORWARD_LEAVES = {"call", "submit", "score", "predict",
                       "predict_multi"}

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            p = mod.rel.replace("\\", "/")
            if "/serving/" not in p:
                continue
            parents = mod.parents()
            for fn in ast.walk(mod.tree):
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                # Driver-level only (the obs-span convention): nested
                # closures are checked through the enclosing driver.
                if not isinstance(parents.get(fn),
                                  (ast.Module, ast.ClassDef)):
                    continue
                sites = self._routing_sites(fn)
                if not sites:
                    continue
                if self._feeds_monitor(fn):
                    continue
                yield self.finding(
                    mod, sites[0],
                    f"{fn.name}() forwards or sheds fleet traffic but "
                    f"never records it — call _record_route(...) / "
                    f"_record_shed(...) so the routing decision lands "
                    f"in the fleet.route/fleet.shed counters (the SLO "
                    f"signal)")

    @classmethod
    def _routing_sites(cls, fn) -> List[int]:
        """Lines where ``fn`` makes a routing decision: forwards a
        request into a replica's engine (a call through an ``engine``
        attribute with a dispatch-surface leaf) or sheds one (raises
        ``FleetOverloadError``)."""
        lines: List[int] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                path = (dotted(node.func) or "").split(".")
                if len(path) >= 2 and path[-2] == "engine" \
                        and path[-1] in cls._FORWARD_LEAVES:
                    lines.append(node.lineno)
            elif isinstance(node, ast.Raise) and node.exc is not None:
                exc = node.exc
                name = exc.func if isinstance(exc, ast.Call) else exc
                if (dotted(name) or "").split(".")[-1] \
                        == "FleetOverloadError":
                    lines.append(node.lineno)
        return lines


# ------------------------------------------------------------ threads

class ThreadHygieneRule(Rule):
    """Every ``threading.Thread`` the package creates must have a join
    on an owner close path: stored on ``self.x`` — some method of the
    class joins ``self.x``; a local — joined in the same function."""

    id = "thread"
    incident = ("prefetch producer / serving queue discipline: an "
                "unjoined worker outlives close() and races teardown")

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call) and (
                        dotted(node.func) in ("threading.Thread",
                                              "Thread")):
                    yield from self._check_site(mod, node)

    def _check_site(self, mod: Module, call: ast.Call) -> Iterator[Finding]:
        parent = mod.parents().get(call)
        target: Optional[str] = None
        if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
            target = dotted(parent.targets[0])
        if target is None:
            yield self.finding(
                mod, call.lineno,
                "Thread created without binding it — nothing can ever "
                "join it")
            return
        if target.startswith("self."):
            cls = mod.enclosing(call, (ast.ClassDef,))
            if cls is None or not self._class_joins(cls, target):
                yield self.finding(
                    mod, call.lineno,
                    f"Thread stored on {target} but no method of the "
                    f"owning class joins it (close()/stop()/__exit__)")
        else:
            fn = mod.enclosing(call, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
            if fn is None or not self._scope_joins(fn, target):
                yield self.finding(
                    mod, call.lineno,
                    f"Thread bound to local {target!r} but this "
                    f"function never joins it")

    @staticmethod
    def _class_joins(cls: ast.ClassDef, target: str) -> bool:
        for node in ast.walk(cls):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join" \
                    and (dotted(node.func.value) or "") == target:
                return True
        return False

    @staticmethod
    def _scope_joins(fn, target: str) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "join" \
                    and (dotted(node.func.value) or "") == target:
                return True
        return False


# ------------------------------------------------------ counter-reset

class CounterResetRule(Rule):
    """Classes with a ``fit`` method: every trailing-underscore
    (fitted/audit) attribute any method assigns must be declared in the
    init/reset region — ``__init__`` or a ``*reset*`` method of the
    class or an in-package ancestor — so a read before (or after a
    differently-pathed) fit sees a defined, deliberately-chosen value
    instead of a stale one."""

    id = "counter-reset"
    incident = ("r9 stale-audit class: checkpoint_segments_ survived "
                "into fits that never set it")

    def run(self, pkg: Package) -> Iterator[Finding]:
        # EVERY class body is visited, including same-named classes in
        # different modules (a coverage gate must not drop a class to a
        # name collision); the by-name map is only for base resolution,
        # where the first definition wins (ambiguous bases are rare and
        # resolve conservatively — extra declared attrs, never fewer
        # checks on the class itself).
        all_classes: List[tuple] = []               # (Module, ClassDef)
        classes: Dict[str, ast.ClassDef] = {}
        for mod in pkg:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.ClassDef):
                    all_classes.append((mod, node))
                    classes.setdefault(node.name, node)
        for mod, cls in all_classes:
            if not any(isinstance(n, ast.FunctionDef) and n.name == "fit"
                       for n in cls.body):
                continue
            declared = self._declared_attrs(cls, classes)
            for method in cls.body:
                if not isinstance(method, ast.FunctionDef):
                    continue
                if self._is_reset_region(method.name):
                    continue
                for line, attr in self._stored_attrs(method):
                    if attr not in declared:
                        yield self.finding(
                            mod, line,
                            f"{cls.name}.{method.name} assigns audit attr "
                            f"self.{attr} never declared in __init__ "
                            f"or a *reset* method — stale across fits "
                            f"and undefined before the first")

    @staticmethod
    def _is_reset_region(method_name: str) -> bool:
        return method_name == "__init__" or "reset" in method_name

    def _declared_attrs(self, cls: ast.ClassDef,
                        classes: Dict[str, ast.ClassDef],
                        seen: Optional[Set[str]] = None) -> Set[str]:
        seen = seen if seen is not None else set()
        if cls.name in seen:
            return set()
        seen.add(cls.name)
        declared: Set[str] = set()
        for method in cls.body:
            if isinstance(method, ast.FunctionDef) \
                    and self._is_reset_region(method.name):
                declared.update(a for _, a in self._stored_attrs(method))
        for base in cls.bases:
            base_name = (dotted(base) or "").split(".")[-1]
            if base_name in classes:
                declared.update(self._declared_attrs(
                    classes[base_name], classes, seen))
        return declared

    @staticmethod
    def _stored_attrs(method: ast.FunctionDef):
        """(line, attr) for every ``self.x_ = ...`` in the method."""
        for node in ast.walk(method):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
                targets = [node.target]
            for t in targets:
                if isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self" \
                        and t.attr.endswith("_") \
                        and not t.attr.endswith("__") \
                        and not t.attr.startswith("_"):
                    yield node.lineno, t.attr


# ------------------------------------------------------- dead-private

class DeadPrivateRule(Rule):
    """Module-level private functions and class-level private methods
    with zero references anywhere in the linted tree: dead code that
    every call site silently bypassed."""

    id = "dead-private"
    incident = ("r11 `_serve_chunk` class: a private helper all call "
                "sites bypassed")

    def run(self, pkg: Package) -> Iterator[Finding]:
        defs = []      # (mod, node, qualifier)
        refs: Dict[str, int] = {}
        for mod in pkg:
            parents = mod.parents()
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    name = node.name
                    parent = parents.get(node)
                    # Only module-level defs and class methods: a
                    # nested closure is used where it is defined.
                    if isinstance(parent, (ast.Module, ast.ClassDef)) \
                            and name.startswith("_") \
                            and not name.startswith("__"):
                        defs.append((mod, node))
                if isinstance(node, ast.Name):
                    refs[node.id] = refs.get(node.id, 0) + 1
                elif isinstance(node, ast.Attribute):
                    refs[node.attr] = refs.get(node.attr, 0) + 1
                elif isinstance(node, ast.Call):
                    # getattr(self, "_x") / monkeypatch.setattr-style
                    # string references — call arguments only, so a
                    # docstring merely MENTIONING a helper never keeps
                    # it alive.
                    for arg in list(node.args) + [k.value
                                                  for k in node.keywords]:
                        for c in ast.walk(arg):
                            if isinstance(c, ast.Constant) \
                                    and isinstance(c.value, str):
                                refs[c.value] = refs.get(c.value, 0) + 1
        for mod, node in defs:
            if refs.get(node.name, 0) == 0:
                yield self.finding(
                    mod, node.lineno,
                    f"private helper {node.name}() has zero references "
                    f"in the linted tree — every call site bypasses it")


# --------------------------------------------------------- cache-name

class CacheNameRule(Rule):
    """Every module-level :class:`~kmeans_tpu_torch.utils.cache.LRUCache`
    construction must pass ``name=``: an unnamed cache is invisible to
    the compile spans (its misses trace as the anonymous ``'cache'``)
    AND to the cost capture (``obs.cost``), whose records key on the
    cache name — so a new cache without one silently falls off both
    the timeline and the device-cost report.  Function-local caches
    (test fixtures, ad-hoc scopes) are exempt: only module-scope caches
    live long enough to be an observability surface."""

    id = "cache-name"
    incident = ("ISSUE 12: unnamed caches are invisible to compile "
                "spans and to device-cost capture")

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            parents = mod.parents()
            for node in ast.walk(mod.tree):
                if not (isinstance(node, ast.Call)
                        and (dotted(node.func) or "").split(".")[-1]
                        == "LRUCache"):
                    continue
                if any(kw.arg == "name" for kw in node.keywords):
                    continue
                if self._enclosing_scope_is_module(parents, node):
                    yield self.finding(
                        mod, node.lineno,
                        "module-level LRUCache(...) without name= — "
                        "unnamed caches are invisible to compile spans "
                        "and cost capture; pass name='<module>.<ATTR>'")

    @staticmethod
    def _enclosing_scope_is_module(parents: dict, node: ast.AST) -> bool:
        p = parents.get(node)
        while p is not None:
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return False
            if isinstance(p, ast.Module):
                return True
            p = parents.get(p)
        return False


# ------------------------------------------------------------ aot-key

class AotKeyRule(Rule):
    """A member of the cache-key rule family, across processes: every
    write to the store of built kernel libraries — a ``.put(...)`` on a
    ``*store*``-named object
    (:class:`~kmeans_tpu_torch.utils.aot.AOTStore`), or a ``self.put``
    inside a ``*Store*`` class (the store's own ``store``/``fetch``) —
    must derive its key through ``artifact_key(...)`` (``utils/aot.py``),
    the one constructor of the library's name and ``-D`` defines, the
    sources' hash, the ``nvcc`` flags, the card's capability and the
    torch/CUDA versions.  A hand-rolled key dict misses components the
    way the cache-key findings missed knobs — except across processes and
    builds, where the library served is a stale or foreign build rather
    than a same-process wrong program.  Replaces
    ``kmeans_tpu/analysis/rules.py:1036-1107`` (the XLA executable
    store)."""

    id = "aot-key"
    incident = ("r14 cache-key class, cross-process: an AOT artifact "
                "keyed without a version/backend/in-memory-key field "
                "serves a stale executable to a later build")

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            for node in ast.walk(mod.tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "put"):
                    continue
                base = dotted(node.func.value) or ""
                leaf = base.split(".")[-1].lower()
                if "store" not in leaf and not self._store_method(mod,
                                                                 node):
                    continue
                key_arg = node.args[0] if node.args else next(
                    (kw.value for kw in node.keywords
                     if kw.arg == "fields"), None)
                if key_arg is None or not self._is_blessed(mod, node,
                                                           key_arg):
                    yield self.finding(
                        mod, node.lineno,
                        "library store write with a hand-rolled key — "
                        "derive it with artifact_key(...) (the audited "
                        "constructor spanning the library's name and "
                        "defines, the sources' hash, the nvcc flags, "
                        "the card's capability and the torch/CUDA "
                        "versions)")

    @staticmethod
    def _store_method(mod: Module, call: ast.Call) -> bool:
        """``self.put(...)`` inside a ``*Store*`` class: the store's own
        writes (``AOTStore.store``/``fetch``), where the port's keys are
        made."""
        if dotted(call.func.value) != "self":
            return False
        cls = mod.enclosing(call, (ast.ClassDef,))
        return cls is not None and "store" in cls.name.lower()

    @staticmethod
    def _is_key_call(node: ast.AST) -> bool:
        return isinstance(node, ast.Call) and \
            (dotted(node.func) or "").split(".")[-1] == "artifact_key"

    def _is_blessed(self, mod: Module, call: ast.Call,
                    key_arg: ast.AST) -> bool:
        """Direct ``artifact_key(...)`` argument, or a Name chased to
        its nearest preceding same-function assignment from one (the
        CacheKeyRule._resolve_key discipline)."""
        if self._is_key_call(key_arg):
            return True
        if not isinstance(key_arg, ast.Name):
            return False
        fn = mod.enclosing(call, (ast.FunctionDef, ast.AsyncFunctionDef))
        if fn is None:
            return False
        best = None
        for node in ast.walk(fn):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == key_arg.id
                    and node.lineno <= call.lineno):
                if best is None or node.lineno > best.lineno:
                    best = node
        return best is not None and self._is_key_call(best.value)


# ------------------------------------------------------------- large-k

#: Program builders whose pass materializes a dense (chunk, k) distance
#: tile per device (``parallel.distributed``'s dispatch surface).
_DENSE_TILE_BUILDERS = {
    "make_step_fn", "make_fit_fn", "make_multi_fit_fn",
    "make_predict_fn", "make_transform_fn", "make_score_rows_fn",
    "make_assign_margin_fn",
}
#: Atoms whose presence marks the class as large-k-aware: a planner
#: fit-check (``plan_fit``, ``obs.memory.dense_room``, the KMeans
#: resolution helpers) or a ``k_shard``/``assign`` dispatch branch
#: (names, attributes, spec-dict string keys and the 'two_level' route
#: constant all count).
_LARGE_K_GUARDS = {
    "plan_fit", "dense_room", "_resolve_large_k", "_route_large_k",
    "k_shard", "assign", "two_level",
}
#: Calls that take a program builder as an argument and build through a
#: cache (``models.kmeans._cached``, ``utils.cache.cached_build``).
_BUILDER_TAKERS = {"_cached", "cached_build", "get_or_create",
                   "builder_key"}


class LargeKRule(Rule):
    """Any CLASS that builds dense-tile programs must be large-k-aware:
    it must consult the planner (``plan_fit``, ``dense_room``, or the
    KMeans ``_resolve_large_k``/``_route_large_k`` helpers that wrap it)
    or carry a ``k_shard``/``assign`` dispatch branch routing past the
    memory wall.  A class that unconditionally instantiates the dense
    tile re-opens the failure the massive-k tier closed: at k=64k x
    chunk=8192 the tile alone is 2 GiB per device, an OOM no knob can
    route around after the fact.  Class granularity is the honest scope —
    module-level builder calls (benchmarks, the builder layer itself)
    size their shapes deliberately.  Replaces
    ``kmeans_tpu/analysis/rules.py:1109-1182``: the port mostly passes
    the builder as an argument (``_cached(dist.make_step_fn, ...)``), so
    a class builds one when a ``_DENSE_TILE_BUILDERS`` name is called
    *or* passed to ``_cached``/``cached_build``/``get_or_create``."""

    id = "large-k"
    incident = ("ISSUE 16: an unguarded dense (chunk, k) tile "
                "materialization OOMs at massive k with no dispatch "
                "route around it")

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                sites = self._builder_sites(node)
                if not sites or self._atoms(node) & _LARGE_K_GUARDS:
                    continue
                line, name = sites[0]
                yield self.finding(
                    mod, line,
                    f"class {node.name} builds dense-tile programs "
                    f"({name}) with no plan_fit fit-check and no "
                    f"k_shard/assign dispatch branch — unguarded "
                    f"(chunk, k) tiles OOM at massive k")

    @staticmethod
    def _builder_sites(cls: ast.ClassDef) -> List[Tuple[int, str]]:
        sites: List[Tuple[int, str]] = []
        for c in ast.walk(cls):
            if not isinstance(c, ast.Call):
                continue
            leaf = _leaf(c.func)
            if leaf in _DENSE_TILE_BUILDERS:
                sites.append((c.lineno, leaf))
            elif leaf in _BUILDER_TAKERS:
                for a in list(c.args) + [k.value for k in c.keywords]:
                    if _leaf(a) in _DENSE_TILE_BUILDERS:
                        sites.append((c.lineno, _leaf(a)))
                        break
        return sorted(sites)

    @staticmethod
    def _atoms(node: ast.AST) -> Set[str]:
        """Every symbol-ish atom in the class body: Name ids, Attribute
        components, keyword-argument names, and string constants (spec
        keys like 'assign' and route constants like 'two_level' live as
        strings)."""
        atoms: Set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Name):
                atoms.add(n.id)
            elif isinstance(n, ast.Attribute):
                atoms.add(n.attr)
            elif isinstance(n, ast.keyword) and n.arg:
                atoms.add(n.arg)
            elif isinstance(n, ast.Constant) and isinstance(n.value, str):
                atoms.add(n.value)
        return atoms


# --------------------------------------------------------- fault-path

class FaultPathRule(Rule):
    """In ``orchestrator/`` and ``parallel/``, an ``except`` clause
    catching a FAULT type — preemption/OOM/launch-flake injections,
    transient IO, torn checkpoints, timeouts, the card running out of
    memory — must ROUTE the fault, not swallow it: the handler body must
    re-raise (typed or bare), return a typed ``policy.EXIT_*`` code for
    the supervisor to classify, or call into the committed retry/decision
    machinery (``*retry*``, ``*backoff*``, ``*give_up*``, ``*record*``,
    ``*decision*``, ``*exit*``, or the ``kill``/``terminate``
    escalation).  The autopilot's robustness story is that every fault
    lands in the typed decision log under a committed budget.  Replaces
    ``kmeans_tpu/analysis/rules.py:1184-1270`` with the port's fault
    types: ``utils/faults.py``'s simulated faults,
    ``CheckpointCorruptError``, ``OSError``/``IOError``,
    ``TimeoutError``, ``subprocess.TimeoutExpired``,
    ``torch.cuda.OutOfMemoryError``/``torch.OutOfMemoryError``, the
    trace reader's ``TraceReadError`` and the launcher's
    ``LaunchError``."""

    id = "fault-path"
    incident = ("ISSUE 19: a swallowed fault in the supervised tree — "
                "an except clause that catches a preemption/IO/timeout "
                "fault type and neither re-raises, returns a typed "
                "exit, nor routes through the committed retry policy")

    #: Exception LEAF names that mean "a fault the autopilot owns".
    _FAULT_TYPES = {
        "SimulatedPreemption", "SimulatedOOM", "SimulatedLaunchFailure",
        "SimulatedUpdateFailure", "TransientIOError",
        "CheckpointCorruptError", "LaunchError", "TraceReadError",
        "OSError", "IOError", "TimeoutError", "TimeoutExpired",
        "OutOfMemoryError",
    }
    #: Substrings of a called dotted name that count as routing the
    #: fault into the committed machinery.
    _ROUTING_MARKERS = ("retry", "backoff", "give_up", "record",
                        "decision", "exit", "kill", "terminate")

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            if not _scoped(mod, "/orchestrator/", "/parallel/"):
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                caught = self._caught_faults(node)
                if not caught:
                    continue
                if self._routes(node):
                    continue
                yield self.finding(
                    mod, node.lineno,
                    f"except clause catches fault type(s) "
                    f"{', '.join(sorted(caught))} but neither "
                    f"re-raises, returns a typed EXIT_* code, nor "
                    f"routes through the committed retry policy "
                    f"(call one of *{'*/*'.join(self._ROUTING_MARKERS)}"
                    f"*) — a swallowed fault never reaches the "
                    f"autopilot decision log")

    @classmethod
    def _caught_faults(cls, handler: ast.ExceptHandler) -> Set[str]:
        """Leaf names of fault types this handler catches."""
        t = handler.type
        if t is None:
            return set()        # bare except: other rules' territory
        exprs = t.elts if isinstance(t, ast.Tuple) else [t]
        caught = set()
        for e in exprs:
            leaf = (dotted(e) or "").split(".")[-1]
            if leaf in cls._FAULT_TYPES:
                caught.add(leaf)
        return caught

    @classmethod
    def _routes(cls, handler: ast.ExceptHandler) -> bool:
        for n in ast.walk(handler):
            if isinstance(n, ast.Raise):
                return True
            if isinstance(n, ast.Return) and n.value is not None:
                leaf = (dotted(n.value) or "").split(".")[-1]
                if leaf.startswith("EXIT_"):
                    return True
            if isinstance(n, ast.Call):
                name = (dotted(n.func) or "").lower()
                if any(m in name for m in cls._ROUTING_MARKERS):
                    return True
        return False


# -------------------------------------------------------- atomic-swap

class AtomicSwapRule(Rule):
    """Serving code that rebinds a resident model's table attributes
    (``centroids``/``means_``/... and their f64 carries) or touches the
    identity-keyed device-cache attribute ``_cents_cache`` (the
    ``KMeans._cents_dev`` placement state) must route through the one
    swap helper (``serving.learn.publish_tables``).  The helper owns the
    publication ORDER — auxiliary state first, device placement
    pre-seeded, the ``centroids`` rebind LAST — which is what makes a
    concurrent reader see the old table or the new one, never a torn
    mix.  A future update path writing these attributes inline would
    run correctly, pass single-threaded tests, and publish torn tables
    under load; this rule makes that a static finding.  The port's
    mixture keeps no device cache of its tables (``_params_dev`` places
    them at each call), so the reference's ``_params_cache`` has no
    counterpart here."""

    id = "atomic-swap"
    incident = ("ISSUE 20: an in-place table publication outside the "
                "atomic swap helper — readers could observe a torn "
                "centroid table mid-update")

    #: Attribute leaves whose rebinding IS a table publication: the
    #: model tables the serving dispatch reads (K-Means + GMM
    #: families), their float64 carries/lifetime counts, and the
    #: identity-keyed device cache behind ``_cents_dev``.
    _SWAP_ATTRS = {
        "centroids", "_centroids_f64", "_seen", "cluster_sizes_",
        "_cents_cache",
        "means_", "covariances_", "weights_", "precisions_cholesky_",
    }
    #: The designated swap helpers — the only serving/ functions
    #: allowed to write the attributes above.
    _SWAP_HELPERS = {"publish_tables"}

    def run(self, pkg: Package) -> Iterator[Finding]:
        for mod in pkg:
            p = mod.rel.replace("\\", "/")
            if "/serving/" not in p:
                continue
            exempt: Set[int] = set()
            for fn in ast.walk(mod.tree):
                if isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)) \
                        and fn.name in self._SWAP_HELPERS:
                    for n in ast.walk(fn):
                        exempt.add(id(n))
            for node in ast.walk(mod.tree):
                for line, attr in self._table_stores(node, exempt):
                    yield self.finding(
                        mod, line,
                        f"rebinds model table state .{attr} outside "
                        f"the atomic swap helper — route the "
                        f"publication through "
                        f"serving.learn.publish_tables() so "
                        f"concurrent readers never see a torn table")

    @classmethod
    def _table_stores(cls, node: ast.AST, exempt: Set[int]):
        """(line, attr) for every write/delete of a table attribute in
        ``node`` (Assign/AugAssign/AnnAssign targets and ``del``), one
        entry per statement, skipping the designated helpers."""
        if id(node) in exempt:
            return
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        elif isinstance(node, ast.Delete):
            targets = list(node.targets)
        for t in targets:
            # Unpack tuple/list targets: `a.x, b.y = ...`.
            parts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                else [t]
            for part in parts:
                if isinstance(part, ast.Attribute) \
                        and part.attr in cls._SWAP_ATTRS:
                    yield node.lineno, part.attr
                    return


# -------------------------------------------------------- suppression

class SuppressionFormatRule(Rule):
    """Malformed suppression comments (missing rule list or reason)
    and suppressions naming unknown rule ids are findings — a
    suppression must be auditable, never a silent typo."""

    id = "suppression"
    incident = ("suppressions are explicit and counted, never silent "
                "(ISSUE 10 contract)")

    def run(self, pkg: Package) -> Iterator[Finding]:
        known = set(RULES)
        for mod in pkg:
            for line, comment in mod.malformed_suppressions:
                yield self.finding(
                    mod, line,
                    f"malformed lint suppression {comment!r} — use "
                    f"'# lint: ok(rule-id) — reason'")
            for sup in mod.suppressions.values():
                bad = [r for r in sup.rules if r not in known]
                if bad:
                    yield self.finding(
                        mod, sup.line,
                        f"suppression names unknown rule id"
                        f" {', '.join(bad)} (known: {sorted(known)})")


RULES: Dict[str, Rule] = {rule.id: rule for rule in (
    TraceHazardRule(), CacheKeyRule(), DispatchAccountingRule(),
    ObsSpanRule(), CollectiveSpanRule(), IngestSpanRule(),
    QualityCounterRule(),
    FleetRecordRule(), ThreadHygieneRule(), CounterResetRule(),
    DeadPrivateRule(),
    CacheNameRule(), AotKeyRule(), LargeKRule(),
    FaultPathRule(), AtomicSwapRule(), SuppressionFormatRule(),
)}
