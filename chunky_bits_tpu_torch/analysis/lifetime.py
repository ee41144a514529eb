"""CB4xx — resource-lifetime & deadline-propagation rules (CFG + dataflow).

The Rust reference gets these proofs for free: RAII closes every
fd/flock/mmap on every path out of a scope, and ownership makes leaks
structural errors.  This Python/asyncio rebuild paid twice for their
absence — the ``to_thread(open)`` orphaned-fd cancellation leak and the
unreaped reader tasks were both found *dynamically* (soak flakes, the
CB3xx sweep), not by construction.  This family machine-checks the
discipline over the statement-granular CFGs of ``analysis/cfg.py``:

- CB401 ``fd-leak``       — an acquired handle (``open``/opener
  results, ``os.open``/``fdopen``, ``mmap``, ``socket``, the fsio-seam
  ``open``) must reach a release on EVERY path out of the acquiring
  scope, including the exception and cancellation paths.  Release =
  ``.close()``, custody transfer (returned/yielded, stored into an
  attribute/container, passed to a callee — ``aio.open_in_thread``'s
  closer contract is the async-plane shape), or a ``with`` block.
- CB402 ``lock-discipline`` — ``threading.Lock.acquire()`` /
  ``fcntl.flock(fd, LOCK_EX|LOCK_SH)`` must pair with ``release()`` /
  ``flock(fd, LOCK_UN)`` on every path.  Prefer ``with lock:`` — the
  interpreter then proves the pairing instead of this rule.
- CB403 ``task-custody``  — the CFG-precise upgrade of the syntactic
  CB203: a task assigned from ``create_task``/``ensure_future`` must be
  stored, awaited, or cancelled-AND-awaited on every path out of the
  creating scope (awaiting observes the cancel, so "awaited" covers
  both).  CB203 catches the dropped-expression shape; this rule catches
  the assigned-then-leaked-on-the-error-path shape.
- CB404 ``unbounded-deadline`` — the interprocedural lift of the
  per-module CB101: every CB101-shaped await in code reachable from the
  serving/dispatch/scrub roots must be bounded at SOME frame — a
  ``wait_for``/``run_bounded_dispatch`` at the site or wrapping a call
  on every root path.  Call edges whose every recorded site sits inside
  a bounding wrapper are not traversed, so a deadline proven upstream
  clears the whole subtree ("degrade, never hang" as a whole-program
  property, not a path-list).
- CB405 ``metered-io``    — the scrub/repair exact-metering contract:
  inside ``cluster/scrub.py``/``cluster/repair.py``, every chunk-byte
  ``.read()``/``.write()`` reachable from the scrub/repair roots must
  be dominated by a ``TokenBucket.take()`` charge (must-dataflow; each
  charge covers exactly one I/O — a second read after one ``take``
  re-flags).  A function whose every in-scope call site is dominated by
  a charge is *entered metered* (per-function summaries composed
  through the call graph to fixpoint — the first interprocedural
  dataflow; CB3xx is reachability-only).  Metadata-plane reads are the
  control plane, not chunk I/O, and are exempt by receiver.

Same machinery as every family: suppress inline with
``# lint: <slug>-ok <reason>``; project rules share the per-run
:class:`~chunky_bits_tpu_torch.analysis.reachability.ProjectContext` (call
graph + memoized CFGs — ``--graph-stats`` reports the CFG totals).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from chunky_bits_tpu_torch.analysis.callgraph import attr_chain, iter_body_nodes
from chunky_bits_tpu_torch.analysis.cfg import (
    CFG,
    K_STMT,
    dataflow,
    stmt_expressions,
)
from chunky_bits_tpu_torch.analysis.rules import (
    Finding,
    Rule,
    UnboundedAwaitRule,
    _parents,
)

_FUNC_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


# ---- expression helpers (header-only: a compound statement's CFG node
# ---- evaluates its header; body statements have their own nodes) ----

def _exprs_under(stmt: ast.AST) -> Iterator[ast.AST]:
    """AST nodes evaluated AT this CFG node, nested defs excluded."""
    for expr in stmt_expressions(stmt):
        stack = [expr]
        while stack:
            node = stack.pop()
            yield node
            for child in ast.iter_child_nodes(node):
                if isinstance(child, _FUNC_DEFS + (ast.Lambda,)):
                    continue
                stack.append(child)


def _names_under(expr: ast.AST) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Name):
            out.add(node.id)
    return out


def _rebound_names(stmt: ast.AST) -> set[str]:
    """Local names this statement rebinds (or deletes) — old facts for
    them die here; ``with ... as f`` and ``for f in ...`` count."""
    out: set[str] = set()
    targets: list[ast.AST] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
        targets = [stmt.target]
    elif isinstance(stmt, (ast.For, ast.AsyncFor)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.Delete):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.With, ast.AsyncWith)):
        targets = [item.optional_vars for item in stmt.items
                   if item.optional_vars is not None]
    for t in targets:
        for node in ast.walk(t):
            if isinstance(node, ast.Name):
                out.add(node.id)
    return out


def _common_escapes(stmt: ast.AST) -> set[str]:
    """Names whose custody leaves this scope at ``stmt``: call
    arguments (the callee owns it now — ``closer(f)``,
    ``tasks.append(t)``, ``gather(t)``), returned/yielded values,
    values stored through attribute/subscript targets, plain aliases,
    and ``with`` context expressions.  Receivers (``f.seek()``) are
    USE, not custody — they stay tracked."""
    out: set[str] = set()
    for node in _exprs_under(stmt):
        if isinstance(node, ast.Call):
            for arg in list(node.args) + [kw.value for kw
                                          in node.keywords]:
                out |= _names_under(arg)
        elif isinstance(node, (ast.Yield, ast.YieldFrom)) \
                and node.value is not None:
            out |= _names_under(node.value)
        elif isinstance(node, ast.withitem):
            out |= _names_under(node.context_expr)
    if isinstance(stmt, ast.Return) and stmt.value is not None:
        out |= _names_under(stmt.value)
    if isinstance(stmt, ast.Assign):
        if isinstance(stmt.value, ast.Name):
            # `self._f = x` / `d[k] = x` / `y = x`: custody moved
            out.add(stmt.value.id)
        elif any(not isinstance(t, ast.Name) for t in stmt.targets):
            # storing THROUGH an attribute/subscript/tuple target
            # transfers custody of the stored names too —
            # `self._sessions[k] = (ref, sess, gen, primer)` owns primer
            out |= _stored_names(stmt.value)
    return out


def _stored_names(expr: ast.AST) -> set[str]:
    """Names whose VALUE is being stored by an assignment — call
    receivers (``f.read()``) and attribute bases are use, not custody,
    so they stay tracked."""
    out: set[str] = set()
    stack = [expr]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.Call):
            stack.extend(node.args)
            stack.extend(kw.value for kw in node.keywords)
            continue
        if isinstance(node, ast.Attribute):
            continue
        if isinstance(node, ast.Name):
            out.add(node.id)
        stack.extend(ast.iter_child_nodes(node))
    return out


# ---- the shared leak query ----

class _ResourceSpec:
    """One resource kind: how it is acquired and released."""

    #: enclosing-function names where split acquire/release is the
    #: function's whole JOB (context-manager halves, lock wrappers)
    exempt_functions: tuple[str, ...] = ()
    common_escapes = True

    def acquire(self, stmt: ast.AST) -> Optional[tuple[str, str]]:
        """(variable, description) when ``stmt`` acquires, else None."""
        raise NotImplementedError

    def extra_release(self, stmt: ast.AST,
                      tracked: set[str]) -> set[str]:
        return set()


def _assigned_call(stmt: ast.AST) -> Optional[tuple[str, ast.Call]]:
    """(name, call) for ``x = call(...)`` / ``x = await call(...)``."""
    if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)):
        return None
    value = stmt.value
    if isinstance(value, ast.Await):
        value = value.value
    if isinstance(value, ast.Call):
        return stmt.targets[0].id, value
    return None


def _leaked_facts(cfg: CFG, spec: _ResourceSpec
                  ) -> Iterator[tuple[ast.AST, str, str, str]]:
    """(acquire stmt, var, description, path kind) for every
    acquisition that some path carries unreleased out of the function.
    May-analysis: a fact live at the normal or exceptional exit means
    at least one path leaks it."""
    acquires: list[tuple[int, str, str]] = []
    for idx, stmt in enumerate(cfg.stmts):
        if stmt is None or cfg.kinds[idx] != K_STMT:
            continue
        got = spec.acquire(stmt)
        if got is not None:
            acquires.append((idx, got[0], got[1]))
    if not acquires:
        return
    tracked = {var for _idx, var, _desc in acquires}
    facts = {(var, idx) for idx, var, _desc in acquires}
    gen = [frozenset()] * cfg.n_nodes
    kill = [frozenset()] * cfg.n_nodes
    for idx, stmt in enumerate(cfg.stmts):
        if stmt is None:
            continue
        dead = _rebound_names(stmt) & tracked
        if spec.common_escapes:
            dead |= _common_escapes(stmt) & tracked
        dead |= spec.extra_release(stmt, tracked)
        if dead:
            kill[idx] = frozenset(f for f in facts if f[0] in dead)
    for idx, var, _desc in acquires:
        gen[idx] = gen[idx] | {(var, idx)}
    inn = dataflow(cfg, gen, kill)
    at_exit = inn[cfg.exit] or frozenset()
    at_raise = inn[cfg.raise_exit] or frozenset()
    for idx, var, desc in acquires:
        fact = (var, idx)
        kinds = []
        if fact in at_exit:
            kinds.append("a normal path")
        if fact in at_raise:
            kinds.append("an exception/cancellation path")
        if kinds:
            yield cfg.stmts[idx], var, desc, " and ".join(kinds)


class _LeakRuleBase(Rule):
    """Shared check_project: run the spec's leak query over every
    function's CFG (memoized on the ProjectContext)."""

    project = True
    spec: _ResourceSpec

    def applies(self, rel: str) -> bool:
        return not rel.startswith("analysis/")

    def check(self, sf) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError("project rule: use check_project")

    def _message(self, var: str, desc: str, kind: str,
                 qualname: str) -> str:
        raise NotImplementedError

    def check_project(self, sfs, ctx) -> Iterator[tuple]:
        spec = self.spec
        for _key, info in sorted(ctx.graph.functions.items()):
            if info.rel.startswith("analysis/") \
                    or not isinstance(info.node, _FUNC_DEFS):
                continue
            if info.name in spec.exempt_functions:
                continue
            # cheap pre-scan: only build the CFG when something is
            # acquired in this function at all
            if not any(spec.acquire(s) is not None
                       for s in ast.walk(info.node)
                       if isinstance(s, ast.stmt)):
                continue
            cfg = ctx.cfg_of(info)
            for stmt, var, desc, kind in _leaked_facts(cfg, spec):
                yield (info.rel, stmt.lineno, stmt.col_offset,
                       self._message(var, desc, kind, info.qualname))


# ---- CB401: fd-leak ----

_FD_CHAINS = frozenset({
    "open", "io.open", "os.open", "os.fdopen", "mmap.mmap",
    "socket.socket", "socket.create_connection", "gzip.open",
    "bz2.open", "lzma.open", "tarfile.open",
})


class _FdSpec(_ResourceSpec):
    exempt_functions = ("close", "__exit__", "__aexit__", "__del__")

    def acquire(self, stmt):
        got = _assigned_call(stmt)
        if got is None:
            return None
        var, call = got
        chain = attr_chain(call.func)
        base, _, tail = chain.rpartition(".")
        if chain in _FD_CHAINS or (tail == "open" and "fsio" in base):
            return var, f"{chain}()"
        return None

    def extra_release(self, stmt, tracked):
        out: set[str] = set()
        for node in _exprs_under(stmt):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "close"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in tracked):
                out.add(node.func.value.id)
        return out


class FdLeakRule(_LeakRuleBase):
    """CB401 — acquired handles must reach a release on all CFG paths.

    The reference's ``to_thread(open)`` leak was exactly this shape: an opener's
    handle orphaned on a path the author never drew — ``to_thread``'s
    await cancelled mid-open.  RAII makes that impossible in the Rust
    reference; here the CFG makes it checkable: every ``x = open(...)``
    (or ``os.open``/``fdopen``, ``mmap.mmap``, ``socket.socket``, an
    fsio-seam ``open``) starts a fact the dataflow must see released on
    EVERY path to either exit — normal fall-through, ``return``,
    ``raise``, and the exc edges every call and every ``await``
    (cancellation point) carry.  Releases: ``x.close()``, returning or
    yielding x, storing x into an attribute/container, passing x to a
    callee (custody transfer — ``aio.open_in_thread``'s closer is the
    async shape), a ``with`` block.  Fix pattern: ``with open(...)``
    when the scope is local; the ``try/except BaseException: close;
    raise`` opener guard when the handle outlives the opener (the
    ``FileReader._ensure`` shape); ``# lint: fd-leak-ok <reason>`` for
    deliberate hand-off schemes the dataflow cannot see.
    """

    id = "CB401"
    slug = "fd-leak"
    description = ("acquired file/socket/mmap handles must be released "
                   "or custody-transferred on every CFG path")
    spec = _FdSpec()

    def _message(self, var, desc, kind, qualname):
        return (f"{var} = {desc} in {qualname}() leaks on {kind}: no "
                "close()/custody transfer reaches the scope exit — use "
                "`with`, the opener try/except-BaseException guard, or "
                "aio.open_in_thread custody; justify with "
                "`# lint: fd-leak-ok <reason>`")


# ---- CB402: lock-discipline ----

_LOCK_ACQ_FLAGS = ("LOCK_EX", "LOCK_SH")


def _flock_key(call: ast.Call) -> Optional[str]:
    if attr_chain(call.func).rsplit(".", 1)[-1] != "flock" \
            or len(call.args) < 2:
        return None
    fd = attr_chain(call.args[0]) or "<fd>"
    return f"flock({fd})"


def _flock_flags(call: ast.Call) -> set[str]:
    out: set[str] = set()
    for node in ast.walk(call.args[1]):
        if isinstance(node, ast.Attribute):
            out.add(node.attr)
        elif isinstance(node, ast.Name):
            out.add(node.id)
    return out


class _LockSpec(_ResourceSpec):
    # a context-manager half or lock wrapper IS split acquire/release
    exempt_functions = ("__enter__", "__exit__", "__aenter__",
                       "__aexit__", "acquire", "release", "locked")
    common_escapes = False  # a stored lock still needs its release

    def acquire(self, stmt):
        for node in _exprs_under(stmt):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "acquire":
                chain = attr_chain(node.func.value)
                if chain:
                    return chain, f"{chain}.acquire()"
            key = _flock_key(node)
            if key is not None:
                flags = _flock_flags(node)
                if flags & set(_LOCK_ACQ_FLAGS):
                    return key, f"{key} exclusive/shared"
        return None

    def extra_release(self, stmt, tracked):
        out: set[str] = set()
        for node in _exprs_under(stmt):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "release":
                chain = attr_chain(node.func.value)
                if chain in tracked:
                    out.add(chain)
            key = _flock_key(node)
            if key in tracked and "LOCK_UN" in _flock_flags(node):
                out.add(key)
        return out


class LockDisciplineRule(_LeakRuleBase):
    """CB402 — every acquire pairs with a release on every path.

    A lock held across an unplanned exit is worse than a leaked fd: the
    next acquirer deadlocks, and on this box's single-core runtime a
    wedged flock on ``<root>/.lock`` stops every cross-process slab
    append at once.  The CFG check is the same must-pair query as
    CB401 with ``acquire()``/``release()`` (and ``flock(fd, LOCK_EX)``
    / ``flock(fd, LOCK_UN)``) as the gen/kill pair — custody transfer
    deliberately does NOT release a lock (storing it somewhere is not
    unlocking it).  Preferred fix: ``with lock:`` — the interpreter
    then proves the pairing structurally and this rule never fires; a
    split pair that must stay split (context-manager halves are
    exempted by name) records why with ``# lint: lock-discipline-ok
    <reason>``.
    """

    id = "CB402"
    slug = "lock-discipline"
    description = ("lock/flock acquires must pair with a release on "
                   "every CFG path (prefer `with lock:`)")
    spec = _LockSpec()

    def _message(self, var, desc, kind, qualname):
        return (f"{desc} in {qualname}() is not released on {kind} — "
                "the next acquirer deadlocks; prefer `with lock:` (the "
                "interpreter proves the pairing), else release in a "
                "finally, or justify with "
                "`# lint: lock-discipline-ok <reason>`")


# ---- CB403: task-custody ----

_TASK_TAILS = ("create_task", "ensure_future")


class _TaskSpec(_ResourceSpec):
    def acquire(self, stmt):
        got = _assigned_call(stmt)
        if got is None:
            return None
        var, call = got
        tail = attr_chain(call.func).rsplit(".", 1)[-1]
        if tail in _TASK_TAILS:
            return var, f"{tail}()"
        return None

    def extra_release(self, stmt, tracked):
        out: set[str] = set()
        for node in _exprs_under(stmt):
            if isinstance(node, ast.Await):
                # awaiting anything that mentions the task observes it
                # (await t, await shield(t), await gather(*, t))
                out |= _names_under(node.value) & tracked
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "add_done_callback"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in tracked):
                # the sanctioned done-callback ownership (CB203's
                # custody convention)
                out.add(node.func.value.id)
        return out


class TaskCustodyRule(_LeakRuleBase):
    """CB403 — created tasks keep an owner on every path out of the
    creating scope (the CFG-precise upgrade of the syntactic CB203).

    CB203 flags ``create_task(...)`` whose result is dropped on the
    spot; it cannot see the assigned-then-leaked shape — ``t =
    create_task(...)`` followed by an early return, a raise, or a
    cancellation delivered at an intervening await, with ``t`` never
    stored, awaited, or reaped.  The reference's unreaped reader tasks
    died exactly there.  Custody = awaiting something that mentions the task
    (``await t``, ``await shield(t)``, ``gather``), storing it
    (attribute/container/alias), returning/yielding it, passing it to
    a callee, or ``add_done_callback`` (the done-callback ownership
    CB203 already sanctions).  ``t.cancel()`` alone is NOT custody —
    cancellation is only requested until an await observes it (CB303's
    point, made path-sensitive here).  Suppress deliberate
    fire-and-forget with ``# lint: task-custody-ok <reason>``.
    """

    id = "CB403"
    slug = "task-custody"
    description = ("assigned tasks must be stored/awaited/reaped on "
                   "every CFG path out of the creating scope")
    spec = _TaskSpec()

    def _message(self, var, desc, kind, qualname):
        return (f"{var} = {desc} in {qualname}() loses its owner on "
                f"{kind}: the task is never stored, awaited, or "
                "cancelled-and-awaited there — it outlives the scope "
                "unobserved (leak under SANITIZE, exceptions vanish); "
                "await/gather it, store it, or justify with "
                "`# lint: task-custody-ok <reason>`")


# ---- CB404: unbounded-deadline ----

#: where requests, dispatches, and the scrub walk enter the system —
#: the frames a deadline must exist *somewhere* below
DEADLINE_ROOTS = (
    ("gateway/http.py", "*"),
    ("gateway/workers.py", "*"),
    ("ops/dispatch_pipeline.py", "*"),
    ("cluster/scrub.py", "ScrubDaemon.run"),
)

#: CB101 already polices these by path (with its own suppressions);
#: flagging there again would demand a second marker per site
_DEADLINE_GOVERNED = UnboundedAwaitRule.paths + ("analysis/", "sim/")

#: call wrappers that impose a deadline on everything beneath them
_BOUNDING_TAILS = ("wait_for", "run_bounded_dispatch")


class UnboundedDeadlineRule(Rule):
    """CB404 — every await reachable from a serving/dispatch/scrub root
    is bounded at SOME frame (the interprocedural lift of CB101).

    CB101 proves "degrade, never hang" per module, on a path list —
    which leaves two gaps this rule closes over the call graph.  Gap
    one: a bare await in ``file/location.py`` or ``cluster/cluster.py``
    (off CB101's list) hangs a gateway GET exactly as hard as one in
    ``gateway/``.  Gap two, the converse: a deadline does not have to
    sit AT the await — ``asyncio.wait_for(self._fetch(), t)`` bounds
    every await inside ``_fetch`` and everything it calls.  So the
    traversal starts at the roots (gateway handlers, the worker
    supervisor, the dispatch pipeline, the scrub walk) and refuses to
    cross a call edge whose every recorded call site sits inside a
    bounding wrapper (``wait_for``/``run_bounded_dispatch``): what it
    still reaches is provably deadline-free on some root path, and a
    CB101-shaped await there (bare future/task, ``.wait()``/
    ``.join()``-family) is a real whole-program hang.  Modules CB101
    already governs are excluded — one rule, one marker per site.
    Fix: bound at the site or at the narrowest caller that owns the
    deadline budget; justify liveness-by-construction with
    ``# lint: unbounded-deadline-ok <reason>``.
    """

    id = "CB404"
    slug = "unbounded-deadline"
    description = ("awaits reachable from serving/dispatch/scrub roots "
                   "must be bounded at some frame")
    project = True

    def applies(self, rel: str) -> bool:
        return not rel.startswith(_DEADLINE_GOVERNED)

    def check(self, sf) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError("project rule: use check_project")

    @staticmethod
    def _bounded_site(call: ast.Call, parents: dict) -> bool:
        """True when ``call`` sits inside the argument subtree of a
        bounding wrapper in its own function."""
        cur = parents.get(call)
        while cur is not None and not isinstance(
                cur, _FUNC_DEFS + (ast.Lambda,)):
            if isinstance(cur, ast.Call):
                tail = attr_chain(cur.func).rsplit(".", 1)[-1]
                if tail in _BOUNDING_TAILS:
                    return True
            cur = parents.get(cur)
        return False

    def _unbounded_reachable(self, ctx, roots) -> list:
        """Closure from the roots traversing only call edges with at
        least one deadline-free route (an edge is skipped when every
        recorded call site is inside a bounding wrapper; handoffs with
        no recorded site — spawned tasks — are never bounded)."""
        graph = ctx.graph
        parents_by_rel: dict[str, dict] = {}
        sites_by_edge: dict[tuple, list[ast.Call]] = {}
        for callee, pairs in graph.call_sites.items():
            for caller, call in pairs:
                sites_by_edge.setdefault((caller, callee),
                                         []).append(call)
        seen = set()
        stack = [k for k in roots if k in graph.functions]
        while stack:
            key = stack.pop()
            if key in seen:
                continue
            seen.add(key)
            ctx.note_summary(("deadline", key))
            for callee in graph.edges.get(key, ()):
                if callee in seen:
                    continue
                sites = sites_by_edge.get((key, callee), ())
                if sites:
                    rel = key[0]
                    if rel not in parents_by_rel:
                        sf = ctx.by_rel.get(rel)
                        parents_by_rel[rel] = \
                            _parents(sf.tree) if sf else {}
                    if all(self._bounded_site(c, parents_by_rel[rel])
                           for c in sites):
                        continue  # bounded at every frame that calls it
                stack.append(callee)
        return [ctx.graph.functions[k] for k in seen]

    def check_project(self, sfs, ctx) -> Iterator[tuple]:
        roots = ctx.resolve_roots(DEADLINE_ROOTS)
        if not roots:
            return
        infos = self._unbounded_reachable(ctx, roots)
        infos.sort(key=lambda i: (i.rel, i.lineno, i.qualname))
        for info in infos:
            if info.rel.startswith(_DEADLINE_GOVERNED) \
                    or not isinstance(info.node, ast.AsyncFunctionDef):
                continue
            for node in iter_body_nodes(info.node):
                if not isinstance(node, ast.Await):
                    continue
                value = node.value
                shape = None
                if isinstance(value, (ast.Name, ast.Attribute)):
                    shape = "a bare future/task"
                elif (isinstance(value, ast.Call)
                        and isinstance(value.func, ast.Attribute)
                        and value.func.attr
                        in UnboundedAwaitRule.WATCH):
                    shape = f".{value.func.attr}()"
                if shape is None:
                    continue
                yield (info.rel, node.lineno, node.col_offset,
                       f"await on {shape} in {info.qualname}() is "
                       "reachable from the serving/dispatch/scrub "
                       "roots with no deadline at ANY frame — a dead "
                       "peer or parked device hangs the whole request "
                       "('degrade, never hang'); bound it with "
                       "asyncio.wait_for here or at the caller that "
                       "owns the budget, or justify with "
                       "`# lint: unbounded-deadline-ok <reason>`")


# ---- CB405: metered-io ----

#: where scrub/repair I/O enters: the daemon walk and the planner's
#: per-part entry (both construct/carry the TokenBucket)
METER_ROOTS = (
    ("cluster/scrub.py", "ScrubDaemon.run"),
    ("cluster/repair.py", "repair_part"),
)

#: the metering domain: the modules that OWN the byte budget.  The
#: shared read machinery below them (file/location.py et al.) serves
#: unmetered foreground traffic too — the contract is that scrub and
#: repair charge before they call into it.
_METER_SCOPE = ("cluster/scrub.py", "cluster/repair.py")

_METER_FACT = "metered"


def _take_in_stmt(stmt: ast.AST) -> bool:
    for node in _exprs_under(stmt):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "take"
                and "bucket" in attr_chain(node.func.value).lower()):
            return True
    return False


def _io_calls(stmt: ast.AST) -> list[ast.Call]:
    """Chunk-byte I/O calls in this statement: ``.read()``/``.write()``
    on anything but the metadata plane (control plane, not chunk I/O)."""
    out: list[ast.Call] = []
    for node in _exprs_under(stmt):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("read", "write")
                and "metadata" not in attr_chain(node.func).lower()):
            out.append(node)
    return out


class MeteredIoRule(Rule):
    """CB405 — scrub/repair chunk I/O charges the TokenBucket first.

    ``tunables.scrub_bytes_per_sec`` exists to protect foreground
    traffic; the contract (charged into BASELINE by configs 11/13) is
    *exact* metering — every repair byte charges the budget, charged
    BEFORE the I/O so a burst cannot land and then apologize.  This
    rule proves it with a must-dominance query over the CFGs of every
    ``cluster/scrub.py``/``cluster/repair.py`` function reachable from
    the scrub/repair roots: a ``.read()``/``.write()`` chunk I/O call
    must have a ``bucket.take()`` on EVERY path from the function
    entry, and each charge covers exactly one I/O (the metered fact is
    killed at the I/O, so take-once-read-twice re-flags).  Per-function
    summaries compose through the call graph to fixpoint: a helper
    whose every in-scope call site is itself dominated by a charge is
    *entered metered*, so charge-in-the-caller patterns (``_localize``
    → ``_read_full``) prove through.  Metadata reads/writes are exempt
    by receiver — the ref round-trip is the control plane.  Deliberate
    unmetered I/O (none today) records why with
    ``# lint: metered-io-ok <reason>``.
    """

    id = "CB405"
    slug = "metered-io"
    description = ("scrub/repair-reachable chunk reads/writes must be "
                   "dominated by a TokenBucket charge")
    project = True
    paths = _METER_SCOPE

    def check(self, sf) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError("project rule: use check_project")

    def check_project(self, sfs, ctx) -> Iterator[tuple]:
        roots = ctx.resolve_roots(METER_ROOTS)
        if not roots:
            return
        graph = ctx.graph
        infos = {info.key: info
                 for info in ctx.reachable_infos(roots)
                 if info.rel.startswith(_METER_SCOPE)
                 and isinstance(info.node, _FUNC_DEFS)}
        cfgs = {}
        gens = {}
        kills = {}
        io_nodes: dict[tuple, list[tuple[int, ast.Call]]] = {}
        call_stmt: dict[tuple, dict[int, int]] = {}
        for key, info in infos.items():
            cfg = ctx.cfg_of(info)
            ctx.note_summary(("meter", key))
            cfgs[key] = cfg
            gen = [frozenset()] * cfg.n_nodes
            kill = [frozenset()] * cfg.n_nodes
            sites: list[tuple[int, ast.Call]] = []
            stmt_of: dict[int, int] = {}
            for idx, stmt in enumerate(cfg.stmts):
                if stmt is None:
                    continue
                if _take_in_stmt(stmt):
                    gen[idx] = frozenset({_METER_FACT})
                calls = _io_calls(stmt)
                if calls:
                    # one charge covers one I/O: consume the fact
                    kill[idx] = frozenset({_METER_FACT})
                    for call in calls:
                        sites.append((idx, call))
                for node in _exprs_under(stmt):
                    if isinstance(node, ast.Call):
                        stmt_of[id(node)] = idx
            gens[key], kills[key] = gen, kill
            io_nodes[key] = sites
            call_stmt[key] = stmt_of
        # fixpoint: entered-metered flows caller -> callee through
        # call sites that are themselves must-metered
        entered = {key: False for key in infos}
        inns = {}
        for _round in range(len(infos) + 1):
            for key in infos:
                init = frozenset({_METER_FACT}) if entered[key] \
                    else frozenset()
                inns[key] = dataflow(cfgs[key], gens[key], kills[key],
                                     must=True, init=init)
            changed = False
            for key in infos:
                pairs = [(ck, call) for ck, call
                         in graph.call_sites.get(key, ())
                         if ck in infos]
                if not pairs or entered[key]:
                    continue
                ok = True
                for ck, call in pairs:
                    sidx = call_stmt[ck].get(id(call))
                    state = inns[ck][sidx] if sidx is not None else None
                    if state is None or _METER_FACT not in state:
                        ok = False
                        break
                if ok:
                    entered[key] = True
                    changed = True
            if not changed:
                break
        for key in sorted(infos):
            info = infos[key]
            inn = inns[key]
            for idx, call in io_nodes[key]:
                state = inn[idx]
                if state is not None and _METER_FACT in state:
                    continue
                tail = call.func.attr
                yield (info.rel, call.lineno, call.col_offset,
                       f".{tail}() in {info.qualname}() is reachable "
                       "from the scrub/repair roots but not dominated "
                       "by a bucket.take() charge — unmetered repair "
                       "I/O saturates the disks the byte-rate bound "
                       "exists to protect; charge the TokenBucket "
                       "before the I/O (every path, one charge per "
                       "I/O) or justify with "
                       "`# lint: metered-io-ok <reason>`")


LIFETIME_RULES: tuple[Rule, ...] = (
    FdLeakRule(),
    LockDisciplineRule(),
    TaskCustodyRule(),
    UnboundedDeadlineRule(),
    MeteredIoRule(),
)
