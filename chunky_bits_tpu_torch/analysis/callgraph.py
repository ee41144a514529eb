"""Function-granular project call graph (the CB2xx/CB3xx substrate).

The CB204 cross-plane rule needs "can this function run on a
HostPipeline worker thread?"; the CB3xx family (analysis/flow.py) needs
"can this function run under a durability root / a sim scenario?" —
both are *reachability* questions over one interprocedural graph.  This
module builds it from stdlib ``ast`` alone (no imports executed, no
types inferred):

* **Nodes** are every ``def`` / ``async def`` / ``lambda`` in the
  scanned files, keyed ``(rel, qualname)`` where qualname is the dotted
  class/function nesting path (lambdas get ``<lambda>@line:col``).
* **Edges** resolve in two phases: every module's functions and import
  table are collected first, then call expressions link across module
  boundaries —

  - bare names: same-module functions, then ``from X import f``
    bindings (function-level lazy imports count module-wide);
  - ``self.m()`` / ``cls.m()``: same-module methods named ``m``
    (override-coarse on purpose — a base-class dispatch must reach
    every same-named override the module defines);
  - ``mod.f()`` where ``mod`` is an imported project module (any
    spelling: ``import a.b as mod``, ``from a import b``, relative
    imports): functions named ``f`` in that module;
  - ``Cls.m()`` where ``Cls`` was imported from a project module:
    methods named ``m`` in that module;
  - ``recv.m()`` on any other receiver: *import-scoped* method
    resolution — methods named ``m`` in the calling module and in the
    modules it imports (the middle ground between same-module-only,
    which loses every cross-plane hop, and project-wide, which links
    every ``.write()`` to every writer);
  - decorators: a call edge to a decorated function also edges to its
    project-local decorators (the wrapper actually runs), and the
    decorator edges to the function it wraps;
  - callables that *escape* into another execution context —
    ``functools.partial(f, ...)``, ``asyncio.to_thread(f)``,
    ``loop.run_in_executor(None, f)``, ``threading.Thread(target=f)``,
    ``create_task``/``ensure_future`` over a function reference,
    ``call_soon``/``call_later`` callbacks, host-pipeline ``_Job``/
    ``submit``/``run`` callables, ``add_done_callback`` — edge from
    the handing-off function to the callable.

* **Unknown edges** are counted, never silently dropped: a call whose
  callee is a parameter, a call result, a subscript, or an attribute
  chain that resolves to no known function and no external module is
  dynamic dispatch the graph cannot follow.  ``--graph-stats`` surfaces
  the count so precision regressions are visible in the lint report.
* **Worker roots** are the places code hops OFF the event loop onto a
  plain thread: ``threading.Thread(target=...)``, ``asyncio.to_thread``,
  ``run_in_executor``, job callables handed to the host pipeline
  (``_Job(stage, fn)``, ``.submit(stage, fn)``, ``.run(stage, fn)``
  with a string stage), ``add_done_callback`` callbacks, and
  ``HostPipeline._worker`` itself.  ``call_soon_threadsafe`` /
  ``run_coroutine_threadsafe`` callables are explicitly NOT roots —
  that pair is the sanctioned way back onto the loop.

Over-approximation (same-name collisions, overrides) errs toward
flagging, which the shared ``# lint: <slug>-ok <reason>`` machinery can
excuse; the residual under-approximation (calls through stored
callables) is counted as unknown edges and backstopped by the runtime
harnesses the static rules front-run (sanitizer, crash matrix,
determinism pin).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

#: the sanctioned loop re-entry points: callables passed to these are
#: back ON the loop, so they are never worker roots
THREADSAFE_WRAPPERS = ("call_soon_threadsafe", "run_coroutine_threadsafe")

#: method names that are always worker bodies regardless of how they
#: are reached (the scheduler's own run loop)
ALWAYS_ROOT_METHODS = ("_worker",)

#: wrapper tails whose first positional argument is a callable handed
#: to another execution context (edge, but not a worker root)
_CALLBACK_WRAPPERS = ("create_task", "ensure_future", "call_soon",
                      "call_later", "call_at")

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def attr_chain(node: ast.AST) -> str:
    """Dotted name for Name/Attribute chains ('loop.call_soon'), or ''."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


@dataclass
class FuncInfo:
    """One function/method/lambda node in the graph."""

    rel: str
    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef | Lambda
    cls: Optional[str]  # lexically enclosing class, if any

    @property
    def key(self) -> tuple[str, str]:
        return (self.rel, self.qualname)

    @property
    def name(self) -> str:
        return self.qualname.rsplit(".", 1)[-1]

    @property
    def lineno(self) -> int:
        return getattr(self.node, "lineno", 0)


def iter_body_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's OWN statements: descend the body but stop at
    nested def/lambda boundaries (those are separate graph nodes —
    their code runs when *they* are called, not when the outer function
    does)."""
    stack = list(ast.iter_child_nodes(fn))
    # the function's own args/defaults evaluate in the caller, skip the
    # nested bodies only
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _FUNC_NODES):
            continue
        stack.extend(ast.iter_child_nodes(node))


@dataclass
class _ModuleImports:
    """One module's import surface, collected tree-wide (function-level
    lazy imports deliberately count module-wide — a lazy hop is still a
    hop the reachability rules must follow)."""

    #: alias -> project module rel ("fsio" -> "utils/fsio.py")
    modules: dict[str, str] = field(default_factory=dict)
    #: bare name -> (project module rel, name) for ``from X import f``
    names: dict[str, tuple[str, str]] = field(default_factory=dict)
    #: alias -> True for imports that resolve OUTSIDE the scanned tree
    #: (stdlib, third-party) — calls through these are external, not
    #: unknown
    external: set[str] = field(default_factory=set)

    def imported_rels(self) -> set[str]:
        return set(self.modules.values()) | {
            rel for rel, _name in self.names.values()}


class CallGraph:
    """Import-aware, function-granular call graph over parsed files.

    Build with :func:`build_call_graph` (two-phase: ``add_module`` for
    every file, then ``finalize``)."""

    def __init__(self) -> None:
        self.functions: dict[tuple[str, str], FuncInfo] = {}
        #: key -> set of callee keys
        self.edges: dict[tuple[str, str], set[tuple[str, str]]] = {}
        #: callee key -> [(caller key, ast.Call at the call site)] for
        #: direct-call edges (CB305 walks these to judge arguments)
        self.call_sites: dict[tuple[str, str],
                              list[tuple[tuple[str, str], ast.Call]]] = {}
        self.roots: set[tuple[str, str]] = set()
        #: (caller, callee) pairs that cross BACK to the loop plane
        #: (call_soon_threadsafe / run_coroutine_threadsafe handoffs):
        #: traversed for general reachability, never by the worker
        #: closure — they are the sanctioned plane crossing CB204
        #: exists to steer code toward
        self.loop_edges: set[tuple[tuple[str, str],
                                   tuple[str, str]]] = set()
        #: caller key -> count of dynamic-dispatch calls the graph
        #: could not resolve ('' key: module-level code)
        self.unknown_edges: dict[tuple[str, str], int] = {}
        #: per (rel, last-name-segment) function lookup for resolution
        self._by_name: dict[tuple[str, str], list[FuncInfo]] = {}
        self._imports: dict[str, _ModuleImports] = {}
        self._trees: dict[str, ast.AST] = {}
        self._node_maps: dict[str, dict] = {}
        #: project-module dotted-path suffixes -> rel, for resolving
        #: absolute imports whatever the package prefix is
        self._module_rels: set[str] = set()

    # ---- derived stats ----

    @property
    def unknown_edge_count(self) -> int:
        return sum(self.unknown_edges.values())

    @property
    def edge_count(self) -> int:
        return sum(len(v) for v in self.edges.values())

    def stats(self) -> dict:
        return {
            "functions": len(self.functions),
            "edges": self.edge_count,
            "worker_roots": len(self.roots),
            "unknown_edges": self.unknown_edge_count,
            "modules": len(self._trees),
        }

    # ---- phase 1: collection ----

    def add_module(self, rel: str, tree: ast.AST) -> None:
        self._trees[rel] = tree
        self._module_rels.add(rel)
        self._node_maps[rel] = self._collect_functions(rel, tree)

    def _add_function(self, info: FuncInfo) -> None:
        self.functions[info.key] = info
        self.edges.setdefault(info.key, set())
        self._by_name.setdefault((info.rel, info.name), []).append(info)

    def _collect_functions(self, rel: str, tree: ast.AST) -> dict:
        """Register every function in ``tree``; returns node -> FuncInfo
        so the edge pass can map callables back to graph nodes."""
        node_map: dict[ast.AST, FuncInfo] = {}

        def visit(node: ast.AST, quals: tuple[str, ...],
                  cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, quals + (child.name,), child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    q = ".".join(quals + (child.name,))
                    info = FuncInfo(rel, q, child, cls)
                    self._add_function(info)
                    node_map[child] = info
                    # nested defs/lambdas belong to no class: calling
                    # self.x() inside them still resolves class-wide
                    visit(child, quals + (child.name,), cls)
                elif isinstance(child, ast.Lambda):
                    q = ".".join(
                        quals + (f"<lambda>@{child.lineno}:"
                                 f"{child.col_offset}",))
                    info = FuncInfo(rel, q, child, cls)
                    self._add_function(info)
                    node_map[child] = info
                    visit(child, quals, cls)
                else:
                    visit(child, quals, cls)

        visit(tree, (), None)
        return node_map

    # ---- import resolution ----

    def _rel_for_module(self, dotted: str, from_rel: str,
                        level: int = 0) -> Optional[str]:
        """Project rel path for a dotted module name, or None when the
        module is outside the scanned tree.  Tries the dotted path as
        given and with leading package segments stripped (the scan root
        is usually the package dir, so ``chunky_bits_tpu.utils.fsio``
        must resolve to ``utils/fsio.py``); relative imports resolve
        against the importing module's package directory."""
        if level > 0:
            base = from_rel.rsplit("/", 1)[0] if "/" in from_rel else ""
            for _ in range(level - 1):
                base = base.rsplit("/", 1)[0] if "/" in base else ""
            prefix = f"{base}/" if base else ""
            parts = dotted.split(".") if dotted else []
            cand = prefix + "/".join(parts)
            for suffix in (".py", "/__init__.py"):
                rel = (cand + suffix) if parts else (cand.rstrip("/")
                                                    + "/__init__.py")
                if rel in self._module_rels:
                    return rel
            return None
        parts = dotted.split(".")
        for start in range(len(parts)):
            cand = "/".join(parts[start:])
            for rel in (f"{cand}.py", f"{cand}/__init__.py"):
                if rel in self._module_rels:
                    return rel
        return None

    def _collect_imports(self, rel: str, tree: ast.AST
                         ) -> _ModuleImports:
        imp = _ModuleImports()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    target = self._rel_for_module(alias.name, rel)
                    bound = alias.asname or alias.name.split(".")[0]
                    if target is not None:
                        # `import a.b.c` binds `a`, but dotted calls
                        # through the full chain resolve via
                        # _rel_for_module at the call site; an asname
                        # binds the leaf module directly
                        if alias.asname is not None:
                            imp.modules[bound] = target
                        else:
                            imp.modules.setdefault(bound, target)
                    else:
                        imp.external.add(bound)
            elif isinstance(node, ast.ImportFrom):
                target = self._rel_for_module(node.module or "", rel,
                                              node.level)
                for alias in node.names:
                    bound = alias.asname or alias.name
                    # `from pkg import mod` may name a submodule:
                    # resolve it FIRST — the parent package's __init__
                    # need not be in the scan for the submodule
                    # binding to be real
                    sub = self._rel_for_module(
                        f"{node.module or ''}.{alias.name}".strip("."),
                        rel, node.level)
                    if sub is not None:
                        imp.modules[bound] = sub
                    elif target is not None:
                        imp.names[bound] = (target, alias.name)
                    else:
                        imp.external.add(bound)
        return imp

    # ---- phase 2: edges + roots ----

    def finalize(self) -> None:
        for rel, tree in self._trees.items():
            self._imports[rel] = self._collect_imports(rel, tree)
        for rel, tree in self._trees.items():
            self._link_module(rel, tree)
        # decorator edges: a project-local decorator's wrapper runs when
        # the decorated function is called, and typically calls it
        for info in list(self.functions.values()):
            node = info.node
            for dec in getattr(node, "decorator_list", ()):
                expr = dec.func if isinstance(dec, ast.Call) else dec
                for target in self._resolve_target(info.rel, expr,
                                                   None)[0]:
                    self.edges.setdefault(target.key, set()).add(
                        info.key)
        for info in self.functions.values():
            if info.cls is not None \
                    and info.name in ALWAYS_ROOT_METHODS:
                self.roots.add(info.key)

    def _params_of(self, fn: ast.AST) -> set[str]:
        args = fn.args
        named = (list(args.posonlyargs) + list(args.args)
                 + list(args.kwonlyargs))
        out = {a.arg for a in named}
        for extra in (args.vararg, args.kwarg):
            if extra is not None:
                out.add(extra.arg)
        return out

    def _resolve_target(self, rel: str, expr: ast.AST,
                        params: Optional[set[str]]
                        ) -> tuple[list[FuncInfo], bool]:
        """(candidate functions, unknown?) for a callee expression.

        ``unknown`` is True only for genuinely dynamic dispatch: a
        parameter call, a call-result/subscript call, or an attribute
        chain with no candidates that does not route through a known
        external module."""
        if isinstance(expr, ast.Name):
            name = expr.id
            local = list(self._by_name.get((rel, name), []))
            imp = self._imports.get(rel)
            if imp is not None and name in imp.names:
                target_rel, target_name = imp.names[name]
                local.extend(self._by_name.get(
                    (target_rel, target_name), []))
            if local:
                return local, False
            if params is not None and name in params:
                return [], True  # call through a parameter
            return [], False  # builtin / external name
        if isinstance(expr, ast.Attribute):
            method = expr.attr
            base = attr_chain(expr.value)
            imp = self._imports.get(rel)
            if base in ("self", "cls"):
                cands = [f for f in self._by_name.get((rel, method), [])
                         if f.cls is not None]
                # self.attr calls with no same-module method: stored
                # callables / cross-module bases — dynamic dispatch
                return cands, not cands
            if imp is not None:
                head = base.split(".", 1)[0]
                # full dotted module path (package.mod.func())
                dotted_rel = self._rel_for_module(base, rel) \
                    if base else None
                if dotted_rel is not None:
                    return list(self._by_name.get(
                        (dotted_rel, method), [])), False
                if base in imp.modules:
                    return list(self._by_name.get(
                        (imp.modules[base], method), [])), False
                if base in imp.names:
                    # imported class: methods in its home module
                    target_rel, _cls = imp.names[base]
                    return list(self._by_name.get(
                        (target_rel, method), [])), False
                if head in imp.external or head in imp.modules:
                    return [], False
            # import-scoped instance-method resolution: methods named
            # `method` in this module and its imported project modules
            scope_rels = [rel]
            if imp is not None:
                scope_rels.extend(sorted(imp.imported_rels()))
            cands = []
            for srel in scope_rels:
                cands.extend(
                    f for f in self._by_name.get((srel, method), [])
                    if f.cls is not None)
            if cands:
                return cands, False
            # receiver unresolved and no candidate anywhere in import
            # scope: stdlib object methods land here too — counted as
            # unknown on purpose (honest over dynamic dispatch)
            return [], True
        if isinstance(expr, (ast.Call, ast.Subscript)):
            return [], True  # f()() / table[k]() — dynamic
        return [], False

    def _resolve_callable(self, rel: str, expr: ast.AST,
                          node_map: dict,
                          params: Optional[set[str]]
                          ) -> list[FuncInfo]:
        """Graph nodes a callable *reference* may denote: a lambda is
        itself; ``functools.partial(f, ...)`` unwraps to ``f``;
        names/attributes resolve like call targets."""
        if isinstance(expr, ast.Lambda):
            info = node_map.get(expr)
            return [info] if info is not None else []
        if isinstance(expr, ast.Call):
            tail = attr_chain(expr.func).rsplit(".", 1)[-1]
            if tail == "partial" and expr.args:
                return self._resolve_callable(rel, expr.args[0],
                                              node_map, params)
            return []
        return self._resolve_target(rel, expr, params)[0]

    def _call_handoffs(self, rel: str, call: ast.Call, node_map: dict,
                       params: Optional[set[str]]
                       ) -> Iterator[tuple[FuncInfo, str]]:
        """(callable, kind) pairs referenced by one Call that hands a
        callable to another execution context.  kind is ``'root'``
        (runs on a worker thread), ``'edge'`` (runs, same plane), or
        ``'loop'`` (runs, but back ON the loop — the threadsafe
        crossing, excluded from the worker closure)."""
        chain = attr_chain(call.func)
        tail = chain.rsplit(".", 1)[-1] if chain else ""
        rooted: list[ast.AST] = []
        linked: list[ast.AST] = []
        looped: list[ast.AST] = []
        if tail == "Thread":
            for kw in call.keywords:
                if kw.arg == "target":
                    rooted.append(kw.value)
        elif tail == "to_thread" and call.args:
            rooted.append(call.args[0])
        elif tail == "run_in_executor" and len(call.args) >= 2:
            rooted.append(call.args[1])
        elif tail == "_Job" and len(call.args) >= 2:
            rooted.append(call.args[1])
        elif (tail in ("submit", "run") and len(call.args) >= 2
                and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)):
            # HostPipeline.submit(stage, fn) / await pipeline.run(stage,
            # fn) — the string stage distinguishes them from
            # concurrent.futures submit(fn, ...) and asyncio.run(coro)
            rooted.append(call.args[1])
        elif tail == "add_done_callback" and call.args:
            # completion callbacks run on whichever thread finishes the
            # job — for pipeline jobs that is a worker
            rooted.append(call.args[0])
        elif tail in THREADSAFE_WRAPPERS and call.args:
            # the sanctioned worker->loop crossing: the callable runs
            # on the loop, so worker-ness must NOT flow through it
            looped.append(call.args[0])
        elif tail in _CALLBACK_WRAPPERS and call.args:
            # loop-side callables: an edge (the code runs), not a root
            linked.append(call.args[0])
        for expr in rooted:
            for info in self._resolve_callable(rel, expr, node_map,
                                               params):
                # an async def handed to a thread only builds a
                # coroutine object there — its body runs on a loop,
                # never the worker, so it cannot seed worker-ness
                if isinstance(info.node, ast.AsyncFunctionDef):
                    yield info, "edge"
                else:
                    yield info, "root"
        for expr in linked:
            for info in self._resolve_callable(rel, expr, node_map,
                                               params):
                yield info, "edge"
        for expr in looped:
            for info in self._resolve_callable(rel, expr, node_map,
                                               params):
                yield info, "loop"

    def _link_call(self, rel: str, caller_key: tuple[str, str],
                   call: ast.Call, node_map: dict,
                   params: Optional[set[str]]) -> None:
        for info, kind in self._call_handoffs(rel, call, node_map,
                                              params):
            if kind == "root":
                self.roots.add(info.key)
            elif kind == "loop":
                self.loop_edges.add((caller_key, info.key))
            self.edges.setdefault(caller_key, set()).add(info.key)
        targets, unknown = self._resolve_target(rel, call.func, params)
        if unknown:
            self.unknown_edges[caller_key] = \
                self.unknown_edges.get(caller_key, 0) + 1
        for info in targets:
            self.edges.setdefault(caller_key, set()).add(info.key)
            self.call_sites.setdefault(info.key, []).append(
                (caller_key, call))
            # calling a decorated function actually calls its wrapper:
            # edge to the project-local decorators too (added in
            # finalize's decorator pass via the reverse direction)

    def _link_module(self, rel: str, tree: ast.AST) -> None:
        node_map = self._node_maps[rel]
        in_function: set[int] = set()
        for info in [i for i in self.functions.values()
                     if i.rel == rel]:
            fn_params = self._params_of(info.node) \
                if not isinstance(info.node, ast.Lambda) \
                else {a.arg for a in info.node.args.args}
            for node in iter_body_nodes(info.node):
                if not isinstance(node, ast.Call):
                    continue
                in_function.add(id(node))
                self._link_call(rel, info.key, node, node_map,
                                fn_params)
        # module-level code (import-time Thread spawns etc.) can also
        # hand out roots; its calls attribute to the ('' qualname)
        # pseudo-caller for unknown-edge accounting
        module_key = (rel, "")
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and id(node) not in in_function:
                for info, kind in self._call_handoffs(
                        rel, node, node_map, None):
                    if kind == "root":
                        self.roots.add(info.key)
                    elif kind == "loop":
                        self.loop_edges.add((module_key, info.key))
                    self.edges.setdefault(module_key, set()).add(
                        info.key)

    # ---- queries ----

    def reachable(self, roots: Iterable[tuple[str, str]]
                  ) -> set[tuple[str, str]]:
        """Keys of every function reachable from ``roots`` (inclusive,
        for roots that are graph nodes)."""
        seen: set[tuple[str, str]] = set()
        stack = [key for key in roots if key in self.functions]
        while stack:
            key = stack.pop()
            if key in seen:
                continue
            seen.add(key)
            stack.extend(self.edges.get(key, ()))
        return seen

    def worker_reachable(self) -> set[tuple[str, str]]:
        """Keys of every function whose body can execute on a worker
        thread.  Narrower than ``reachable(roots)`` on two counts:
        loop-crossing edges (callables handed back through
        call_soon_threadsafe / run_coroutine_threadsafe) are not
        traversed, and async defs are never entered — a worker calling
        an ``async def`` only builds a coroutine object; the body runs
        on an event loop."""

        def _is_async(key: tuple[str, str]) -> bool:
            info = self.functions.get(key)
            return info is not None and isinstance(
                info.node, ast.AsyncFunctionDef)

        seen: set[tuple[str, str]] = set()
        stack = [key for key in self.roots
                 if key in self.functions and not _is_async(key)]
        while stack:
            key = stack.pop()
            if key in seen:
                continue
            seen.add(key)
            for nxt in self.edges.get(key, ()):
                if (key, nxt) in self.loop_edges or _is_async(nxt):
                    continue
                stack.append(nxt)
        return seen

    def functions_in(self, rel_prefix: str) -> Iterator[FuncInfo]:
        for info in self.functions.values():
            if info.rel.startswith(rel_prefix):
                yield info


def build_call_graph(files: Iterable) -> CallGraph:
    """Graph over ``SourceFile``s (anything with ``.rel`` + ``.tree``)."""
    graph = CallGraph()
    for sf in files:
        graph.add_module(sf.rel, sf.tree)
    graph.finalize()
    return graph
