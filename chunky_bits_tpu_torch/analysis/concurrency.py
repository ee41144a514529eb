"""CB2xx — concurrency-hazard rules for the two-plane runtime.

The host plane is genuinely concurrent since the shared pipeline
(parallel/host_pipeline.py) started feeding the asyncio gateway: daemon
worker threads complete jobs whose waiters live on event loops, and the
per-loop shared batchers/caches (ops/batching.py, file/chunk_cache.py)
are lock-free only because all their bookkeeping stays on one loop
thread.  The CB1xx rules check single-function invariants; this family
checks the hazards that cross those lines:

- CB201 ``async-blocking``   — a sync blocking call (``time.sleep``,
  file/socket I/O, ``subprocess``) inside ``async def`` stalls every
  request on the loop, not just its own.
- CB202 ``lock-across-await`` — a ``threading.Lock`` held across an
  ``await`` parks the loop thread in a sync lock while the lock owner
  may need the loop to progress: classic two-plane deadlock.
- CB203 ``task-leak``        — a dropped ``create_task`` result is a
  task nobody awaits: its exception is swallowed at GC and tier-1's
  leak-strict mode can't see it.
- CB204 ``cross-plane``      — code reachable from HostPipeline worker
  bodies (see ``callgraph.py``) touching loop-bound state (``loop.
  call_soon``, ``asyncio.Event.set``, methods of ``LOOP_BOUND``-tagged
  classes) without going through ``call_soon_threadsafe`` /
  ``run_coroutine_threadsafe`` corrupts single-loop invariants.
- CB205 ``loop-shared``      — module/class-level mutable state in the
  serve-path packages outlives and spans event loops; per-loop
  singletons use the established loop-keyed pattern
  (``Cluster._encode_batcher``-style WeakKeyDictionary) or justify
  process-wide sharing inline.

All stdlib-``ast``, same suppression/baseline machinery as CB1xx, runs
with no device.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from chunky_bits_tpu_torch.analysis.callgraph import (
    THREADSAFE_WRAPPERS,
    attr_chain,
    iter_body_nodes,
)
from chunky_bits_tpu_torch.analysis.rules import Finding, Rule

#: the serve-path packages whose shared objects are per-event-loop by
#: convention (cluster.py hands out batchers/caches loop-keyed);
#: cluster/scrub.py and cluster/repair.py ride along — the scrub
#: daemon's task/counters and the repair planner's metered I/O are
#: exactly the loop/thread-handoff shape this family polices
#: obs/ rides along: the metrics registry and trace buffer ARE shared
#: process-wide by design — the rule makes each such site say so
#: inline instead of growing silently
LOOP_SCOPED_PATHS = ("gateway/", "file/", "parallel/", "obs/",
                     "cluster/scrub.py", "cluster/repair.py")

#: class-body marker the CB204 pass reads: every public method of a
#: ``LOOP_BOUND = True`` class must only ever run on the owning loop's
#: thread (see ops/batching.py, file/chunk_cache.py)
LOOP_BOUND_ATTR = "LOOP_BOUND"


def _last(chain: str) -> str:
    return chain.rsplit(".", 1)[-1] if chain else ""


# ---- shared binding tables -------------------------------------------------
#
# Name-based, module-coarse tracking of what a variable/attribute was
# constructed as.  ``self.X = threading.Event()`` records attr name X;
# a later ``anything.X.set()`` resolves X through the table.  Collisions
# across classes err toward the *threading* kinds (which the rules treat
# as safe), so a coarse match can only lose findings, never invent them
# for thread-safe primitives.

_THREADING_LOCKS = ("Lock", "RLock", "Condition", "Semaphore",
                    "BoundedSemaphore")
_LOOP_BOUND_CTORS = {
    "asyncio.Event": "aio_event",
    "asyncio.Queue": "aio_queue",
    "asyncio.Condition": "aio_cond",
    "asyncio.Lock": "aio_lock",
    "asyncio.Future": "aio_future",
}


def _import_map(tree: ast.AST) -> dict[str, str]:
    """Bare name -> source module for ``from X import Y`` bindings, so
    ``Event()`` disambiguates between threading and asyncio."""
    out: dict[str, str] = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = node.module
    return out


def _ctor_kind(value: ast.AST, imports: dict[str, str]) -> str:
    """Classify a constructor-call RHS: 'lock', 'thread_event',
    'aio_event', 'aio_future', ... or ''."""
    if not isinstance(value, ast.Call):
        return ""
    chain = attr_chain(value.func)
    if not chain:
        return ""
    if "." not in chain:
        src = imports.get(chain, "")
        if src:
            chain = f"{src}.{chain}"
    if chain.startswith("threading."):
        tail = _last(chain)
        if tail in _THREADING_LOCKS:
            return "lock"
        if tail == "Event":
            return "thread_event"
        return ""
    if chain in _LOOP_BOUND_CTORS:
        return _LOOP_BOUND_CTORS[chain]
    if _last(chain) == "create_future":
        return "aio_future"
    return ""


def _binding_table(tree: ast.AST, imports: dict[str, str]
                   ) -> dict[str, str]:
    """name-or-attr-name -> ctor kind, module-wide."""
    table: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        kind = _ctor_kind(value, imports)
        if not kind:
            continue
        for tgt in targets:
            if isinstance(tgt, ast.Name):
                table.setdefault(tgt.id, kind)
            elif isinstance(tgt, ast.Attribute):
                table.setdefault(tgt.attr, kind)
    return table


# ---- CB201 ----------------------------------------------------------------

class AsyncBlockingCallRule(Rule):
    """CB201 — the event loop must never execute a sync blocking call.

    One stalled callback stalls every in-flight request on that loop
    (gateway GET/PUT, batcher drains, cache singleflight waiters).  The
    watchlist is the sync-API class — ``time.sleep``, direct ``open``,
    sync filesystem metadata ops, ``subprocess``, sync sockets/HTTP;
    unbounded ``Future.result()``/``queue.get()`` waits are CB101's.
    The fix is a hop: ``asyncio.to_thread``, the host pipeline's
    ``run()``, or ``loop.run_in_executor``.  A deliberately-inline fast
    syscall records why with ``# lint: async-blocking-ok <reason>``.
    Nested sync ``def``s inside an ``async def`` are exempt — they run
    wherever they are shipped (usually a worker), not on the loop.
    """

    id = "CB201"
    slug = "async-blocking"
    description = ("no sync blocking calls (sleep/file/socket/"
                   "subprocess) inside async def")

    NAME_CALLS = ("open",)
    #: exact dotted chains
    ATTR_CALLS = frozenset((
        "time.sleep",
        "os.system", "os.popen",
        "os.stat", "os.listdir", "os.scandir", "os.makedirs",
        "os.mkdir", "os.remove", "os.unlink", "os.replace",
        "os.rename", "os.rmdir", "os.chmod", "os.truncate",
        "os.path.exists", "os.path.isfile", "os.path.isdir",
        "os.path.islink", "os.path.getsize", "os.path.getmtime",
        "socket.create_connection", "socket.getaddrinfo",
        "socket.gethostbyname",
        "urllib.request.urlopen",
    ))
    #: flagged by chain prefix
    PREFIX_CALLS = ("subprocess.", "shutil.", "requests.", "os.spawn")
    #: pathlib-style blocking tails, receiver-agnostic
    TAIL_CALLS = frozenset((
        "read_text", "read_bytes", "write_text", "write_bytes",
    ))

    def _blocking(self, call: ast.Call) -> Optional[str]:
        func = call.func
        if isinstance(func, ast.Name):
            return func.id if func.id in self.NAME_CALLS else None
        chain = attr_chain(func)
        if chain in self.ATTR_CALLS:
            return chain
        if any(chain.startswith(p) for p in self.PREFIX_CALLS):
            return chain
        if isinstance(func, ast.Attribute) \
                and func.attr in self.TAIL_CALLS:
            return f".{func.attr}"
        return None

    def check(self, sf) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.AsyncFunctionDef):
                continue
            for sub in iter_body_nodes(node):
                if not isinstance(sub, ast.Call):
                    continue
                name = self._blocking(sub)
                if name is not None:
                    yield (sub.lineno, sub.col_offset,
                           f"sync blocking call {name}() inside async "
                           f"def {node.name}() stalls the event loop; "
                           "hop via asyncio.to_thread / the host "
                           "pipeline, or justify with "
                           "`# lint: async-blocking-ok <reason>`")


def _first_suspension_outside_nested(stmt: ast.AST
                                     ) -> Optional[ast.AST]:
    """First suspension point under ``stmt`` that executes as part of
    ``stmt`` itself: ``await``, plus the implicit suspensions of
    ``async for`` and ``async with``.  Nested def/lambda subtrees
    (including ``stmt`` being one) are skipped: their awaits run when
    they are called."""
    stack = [stmt]
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
            return node
        stack.extend(ast.iter_child_nodes(node))
    return None


# ---- CB202 ----------------------------------------------------------------

class LockAcrossAwaitRule(Rule):
    """CB202 — a ``threading.Lock`` must not be held across ``await``.

    While the coroutine is suspended the loop thread may run any other
    callback; one that needs the same sync lock blocks the whole loop
    — and if releasing the lock requires the loop to progress, that is
    a deadlock, not a stall.  Covers the ``with <lock>:`` idiom over
    locks recognized by the module-wide binding table (``threading.
    Lock/RLock/Condition/Semaphore`` assigned to names or ``self``
    attributes); suspension points are ``await`` plus the implicit
    ones of ``async for`` / ``async with``.  Hold the lock only around sync sections, or use an
    ``asyncio.Lock``; a provably-awaitless critical section that still
    trips the table records why with
    ``# lint: lock-across-await-ok <reason>``.
    """

    id = "CB202"
    slug = "lock-across-await"
    description = "no threading.Lock held across an await"

    def check(self, sf) -> Iterator[Finding]:
        imports = _import_map(sf.tree)
        table = _binding_table(sf.tree, imports)
        locks = {name for name, kind in table.items() if kind == "lock"}
        if not locks:
            return
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            for node in iter_body_nodes(fn):
                if not isinstance(node, ast.With):
                    continue
                held = None
                for item in node.items:
                    expr = item.context_expr
                    if isinstance(expr, ast.Call):
                        expr = expr.func  # lock.acquire()-style guards
                    tail = _last(attr_chain(expr))
                    if tail in locks:
                        held = tail
                        break
                if held is None:
                    continue
                found = None
                for inner in node.body:
                    # nested def/lambda bodies excluded: they await
                    # when *they* run, not while this lock is held
                    found = _first_suspension_outside_nested(inner)
                    if found is not None:
                        break
                if found is not None:
                    yield (found.lineno, found.col_offset,
                           f"suspension point while holding threading "
                           f"lock '{held}' stalls the event loop (and "
                           "can deadlock it); release before "
                           "awaiting or use asyncio.Lock, else "
                           "justify with "
                           "`# lint: lock-across-await-ok <reason>`")


# ---- CB203 ----------------------------------------------------------------

class FireAndForgetTaskRule(Rule):
    """CB203 — every spawned task needs an owner.

    A ``create_task``/``ensure_future`` result dropped on the floor is
    a task nobody awaits and nobody cancels: its exception is reported
    only at GC (if ever) and a still-pending one leaks past loop
    teardown — the exact classes the runtime sanitizer counts.  Store
    it, await it, or give it a done-callback; a deliberately detached
    task records its lifecycle argument with
    ``# lint: task-leak-ok <reason>``.
    """

    id = "CB203"
    slug = "task-leak"
    description = ("create_task/ensure_future results must be stored, "
                   "awaited, or given a done-callback")

    SPAWNERS = ("create_task", "ensure_future")

    def check(self, sf) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Expr):
                continue
            call = node.value
            if not isinstance(call, ast.Call):
                continue
            tail = _last(attr_chain(call.func))
            if tail in self.SPAWNERS:
                yield (call.lineno, call.col_offset,
                       f"{tail}() result dropped: the task leaks and "
                       "its exception is swallowed — store/await it or "
                       "add a done-callback, else justify with "
                       "`# lint: task-leak-ok <reason>`")


# ---- CB204 ----------------------------------------------------------------

class CrossPlaneHandoffRule(Rule):
    """CB204 — worker-thread code re-enters the loop only through the
    threadsafe doors.

    Built on the function-granular call graph (callgraph.py), shared
    with the CB3xx family through the per-run ProjectContext: from the
    set of functions reachable off-loop (HostPipeline worker bodies,
    thread targets, job callables, done-callbacks) it flags touches of
    loop-bound state — ``loop.call_soon``/``call_later``/``call_at``,
    ``set``/``clear`` on an ``asyncio.Event``, ``set_result``/
    ``set_exception`` on a loop future, and any method call on an
    object constructed from a ``LOOP_BOUND = True`` class (the
    batchers, the chunk cache).  The sanctioned crossings are
    ``loop.call_soon_threadsafe`` and ``asyncio.
    run_coroutine_threadsafe``; anything else mutates single-loop
    bookkeeping from the wrong thread.  A site that is safe for a
    structural reason the graph cannot see records it with
    ``# lint: cross-plane-ok <reason>``.
    """

    id = "CB204"
    slug = "cross-plane"
    description = ("worker-reachable code must cross to the event loop "
                   "via call_soon_threadsafe/run_coroutine_threadsafe")
    project = True

    LOOP_ONLY_API = ("call_soon", "call_later", "call_at")

    def check(self, sf) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError("project rule: use check_project")

    # -- project-wide tables --

    def _loop_bound_classes(self, sfs) -> set[str]:
        """Names of classes tagged LOOP_BOUND = True, plus subclasses
        (resolved by base-name to a fixpoint across the scanned set)."""
        tagged: set[str] = set()
        bases: dict[str, set[str]] = {}
        for sf in sfs:
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                bases.setdefault(node.name, set()).update(
                    _last(attr_chain(b)) for b in node.bases)
                for stmt in node.body:
                    if (isinstance(stmt, ast.Assign)
                            and any(isinstance(t, ast.Name)
                                    and t.id == LOOP_BOUND_ATTR
                                    for t in stmt.targets)
                            and isinstance(stmt.value, ast.Constant)
                            and stmt.value.value is True):
                        tagged.add(node.name)
        while True:
            grown = {cls for cls, bs in bases.items()
                     if bs & tagged} - tagged
            if not grown:
                return tagged
            tagged |= grown

    def _instance_table(self, sfs, classes: set[str]) -> set[str]:
        """Names/attr-names bound to instances of loop-bound classes."""
        out: set[str] = set()
        for sf in sfs:
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Assign):
                    targets, value = node.targets, node.value
                elif isinstance(node, ast.AnnAssign) \
                        and node.value is not None:
                    targets, value = [node.target], node.value
                else:
                    continue
                if not (isinstance(value, ast.Call)
                        and _last(attr_chain(value.func)) in classes):
                    continue
                for tgt in targets:
                    if isinstance(tgt, ast.Name):
                        out.add(tgt.id)
                    elif isinstance(tgt, ast.Attribute):
                        out.add(tgt.attr)
        return out

    def check_project(self, sfs, ctx) -> Iterator[tuple]:
        graph = ctx.graph
        reachable = graph.worker_reachable()
        if not reachable:
            return
        loop_bound = self._loop_bound_classes(sfs)
        instances = self._instance_table(sfs, loop_bound)
        bindings: dict[str, str] = {}
        for sf in sfs:
            table = _binding_table(sf.tree, _import_map(sf.tree))
            for name, kind in table.items():
                # threading kinds win collisions: a coarse match may
                # only lose findings, never flag a thread-safe primitive
                if bindings.get(name, "").startswith("thread") \
                        or bindings.get(name) == "lock":
                    continue
                bindings[name] = kind
        by_rel = {sf.rel: sf for sf in sfs}
        for key in sorted(reachable):
            info = graph.functions.get(key)
            if info is None or info.rel not in by_rel:
                continue
            exempt = self._threadsafe_args(info.node)
            for node in iter_body_nodes(info.node):
                if not isinstance(node, ast.Call) or node in exempt:
                    continue
                hit = self._loop_bound_touch(node, bindings,
                                             instances)
                if hit is not None:
                    yield (info.rel, node.lineno, node.col_offset,
                           f"{hit} from worker-reachable "
                           f"{info.qualname}(): cross to the loop via "
                           "call_soon_threadsafe/"
                           "run_coroutine_threadsafe, or justify with "
                           "`# lint: cross-plane-ok <reason>`")

    def _threadsafe_args(self, fn: ast.AST) -> set:
        """Call nodes nested in the arguments of a threadsafe wrapper
        (``run_coroutine_threadsafe(cache.get(...), loop)``) are the
        sanctioned crossing itself."""
        out: set = set()
        for node in iter_body_nodes(fn):
            if isinstance(node, ast.Call) and _last(
                    attr_chain(node.func)) in THREADSAFE_WRAPPERS:
                for arg in list(node.args) + [kw.value
                                              for kw in node.keywords]:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Call):
                            out.add(sub)
        return out

    def _loop_bound_touch(self, call: ast.Call, bindings: dict,
                          instances: set) -> Optional[str]:
        func = call.func
        if not isinstance(func, ast.Attribute):
            return None
        method = func.attr
        if method in THREADSAFE_WRAPPERS:
            return None
        if method in self.LOOP_ONLY_API:
            return f"loop.{method}() (not the _threadsafe variant)"
        recv = _last(attr_chain(func.value))
        kind = bindings.get(recv, "")
        if method in ("set", "clear") and kind == "aio_event":
            return f"asyncio.Event '{recv}'.{method}()"
        if method in ("set_result", "set_exception") \
                and kind == "aio_future":
            return f"loop future '{recv}'.{method}()"
        if method in ("put_nowait", "get_nowait") \
                and kind == "aio_queue":
            return f"asyncio.Queue '{recv}'.{method}()"
        if recv in instances and not method.startswith("__"):
            return (f"loop-bound method '{recv}.{method}()' "
                    "(LOOP_BOUND class)")
        return None


# ---- CB205 ----------------------------------------------------------------

class LoopSharedStateRule(Rule):
    """CB205 — serve-path singletons are per-event-loop, not global.

    Module- and class-level mutable containers in ``gateway/``,
    ``file/``, ``parallel/`` are shared by every loop (and every
    worker thread) in the process; the codebase's pattern for shared
    serve-path state is loop-keyed handout from the owning object
    (``Cluster._encode_batcher``-style WeakKeyDictionary per loop).
    Loop-bound asyncio primitives at module/class level are worse
    still: they bind to whichever loop touches them first.  Deliberate
    process-wide state (a lock-guarded singleton like
    ``host_pipeline._SHARED``, an immutable registry) records why with
    ``# lint: loop-shared-ok <reason>``.  Thread-safe primitives
    (``threading.Lock``/``Event``/``local``) and immutables pass.
    """

    id = "CB205"
    slug = "loop-shared"
    description = ("no module/class-level mutable shared state in "
                   "gateway/, file/, parallel/ without the loop-keyed "
                   "pattern")
    paths = LOOP_SCOPED_PATHS

    MUTABLE_CTORS = frozenset((
        "dict", "list", "set", "bytearray", "OrderedDict",
        "defaultdict", "deque", "Counter", "WeakKeyDictionary",
        "WeakValueDictionary", "WeakSet", "Queue", "LifoQueue",
        "SimpleQueue",
    ))
    LOOP_BOUND_CTORS = frozenset((
        "asyncio.Event", "asyncio.Lock", "asyncio.Queue",
        "asyncio.Condition", "asyncio.Semaphore",
    ))
    SAFE_CTORS = frozenset((
        "Lock", "RLock", "Condition", "Semaphore", "BoundedSemaphore",
        "Event", "local", "frozenset", "tuple", "MappingProxyType",
    ))

    def _mutable_value(self, value: ast.AST,
                       imports: dict[str, str]) -> Optional[str]:
        if isinstance(value, (ast.Dict, ast.DictComp)):
            return "dict literal"
        if isinstance(value, (ast.List, ast.ListComp)):
            return "list literal"
        if isinstance(value, (ast.Set, ast.SetComp)):
            return "set literal"
        if not isinstance(value, ast.Call):
            return None
        chain = attr_chain(value.func)
        if "." not in chain and imports.get(chain):
            chain = f"{imports[chain]}.{chain}"
        tail = _last(chain)
        if chain in self.LOOP_BOUND_CTORS or (
                chain.startswith("asyncio.")
                and tail in ("Event", "Lock", "Queue", "Condition",
                             "Semaphore")):
            return f"loop-bound {chain}()"
        if chain.startswith("threading.") or tail in self.SAFE_CTORS:
            return None
        if tail in self.MUTABLE_CTORS:
            return f"{tail}()"
        return None

    def _scan_body(self, body, where: str,
                   imports: dict[str, str]) -> Iterator[Finding]:
        for stmt in body:
            if isinstance(stmt, ast.Assign):
                targets, value = stmt.targets, stmt.value
            elif isinstance(stmt, ast.AnnAssign) \
                    and stmt.value is not None:
                targets, value = [stmt.target], stmt.value
            else:
                continue
            names = [t.id for t in targets if isinstance(t, ast.Name)]
            if not names or all(n.startswith("__") and n.endswith("__")
                                for n in names):
                continue  # __all__ / __slots__ etc.
            desc = self._mutable_value(value, imports)
            if desc is not None:
                yield (stmt.lineno, stmt.col_offset,
                       f"{where} mutable shared state "
                       f"{'/'.join(names)} = {desc}: shared across "
                       "event loops and worker threads — use the "
                       "loop-keyed handout pattern "
                       "(Cluster._encode_batcher-style) or justify "
                       "with `# lint: loop-shared-ok <reason>`")

    def check(self, sf) -> Iterator[Finding]:
        imports = _import_map(sf.tree)
        yield from self._scan_body(sf.tree.body, "module-level",
                                   imports)
        for node in sf.tree.body:
            if isinstance(node, ast.ClassDef):
                yield from self._scan_body(
                    node.body, f"class-level ({node.name})", imports)


CONCURRENCY_RULES: tuple[Rule, ...] = (
    AsyncBlockingCallRule(),
    LockAcrossAwaitRule(),
    FireAndForgetTaskRule(),
    CrossPlaneHandoffRule(),
    LoopSharedStateRule(),
)
