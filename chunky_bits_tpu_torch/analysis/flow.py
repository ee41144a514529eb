"""CB3xx — whole-program reachability rules.

The CB1xx/CB2xx families see one function or one handoff at a time;
this family checks the invariants that are *reachability* properties,
over the shared function-granular call graph (``callgraph.py``) and the
per-run :class:`~chunky_bits_tpu_torch.analysis.reachability.ProjectContext`:

- CB301 ``fsio-escape``  — the crash harness (sim/crash.py) can only
  replay mutations that ride the filesystem seam.  CB109 pins the five
  storage modules by *path*; this rule closes the hole CB109 cannot
  see: a helper in ``utils/`` (or anywhere) that performs a
  durability op off-seam while being transitively reachable from a
  durability root — slab append/mark-dead/compact, atomic chunk
  publication, metadata write, the repair rewrite.
- CB302 ``clock-escape`` — the deterministic simulator swaps the clock
  seam; CB108 pins the cluster/file planes by path.  This rule follows
  the scenario roots (every function in sim/scenario.py) through the
  graph and flags direct wall-clock reads in reachable code OUTSIDE
  CB108's path list — the exact shape that would tick in real time
  inside a virtual-time run and silently skew every duration.
- CB303 ``cancel-safety`` — three cancellation hazards in async defs:
  (a) a handler that catches ``CancelledError`` (explicitly, via
  ``BaseException``, or bare) around awaits and never re-raises — the
  coroutine absorbs its own cancellation and teardown hangs; the
  sanctioned child-reap shape (``task.cancel()`` then ``await task``
  under the handler) passes.  (b) ``task.cancel()`` on a task variable
  never followed by an await/gather that observes it — the task may
  still be running (and holding locks/files) when the cancelling
  coroutine moves on; the sanitizer sees the leak only at runtime.
  (c) an await between a finished write and its ``replace`` in a
  publish-shaped function — a cancellation delivered there strands the
  temp file and loses the atomic-publish guarantee unless shielded.
- CB304 ``sim-purity``   — production planes import NOTHING from
  ``sim/``; the subprocess pin in tests/test_torch_sim.py proves
  it at runtime for the *default* import closure, this rule proves it
  statically for every module and every lazy in-function import.
- CB305 ``label-flow``   — CB107 judges ``.labels()`` arguments
  lexically, so a label fed from a function *parameter* passes even
  when every caller passes an f-string.  This rule follows the
  parameter one call hop to the call sites recorded in the graph and
  applies CB107's open-endedness test to the actual arguments.

Same suppression machinery as every other family:
``# lint: <slug>-ok <reason>`` at the flagged line.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from chunky_bits_tpu_torch.analysis.callgraph import attr_chain, iter_body_nodes
from chunky_bits_tpu_torch.analysis.rules import (
    ClockSeamRule,
    Finding,
    FsioSeamRule,
    MetricLabelCardinalityRule,
    Rule,
    _parents,
)

#: the durability roots: the operations whose op streams the crash
#: harness records and replays.  Specs are (rel, qualname-suffix) — see
#: reachability.ProjectContext.resolve_roots; "write" roots every write
#: method in cluster/metadata.py (both metadata shapes publish).
DURABILITY_ROOTS = (
    ("file/slab.py", "SlabStore.append"),
    ("file/slab.py", "SlabStore.mark_dead"),
    ("file/slab.py", "SlabStore.compact"),
    ("file/location.py", "_publish_atomically"),
    ("cluster/metadata.py", "write"),
    ("cluster/repair.py", "repair_part"),
    ("cluster/scrub.py", "_rewrite_replicas"),
)

#: modules where durability ops are already governed (CB109's path
#: scope) or ARE the seam — CB301 flagging there would demand a second
#: suppression for the same site
_FSIO_GOVERNED = FsioSeamRule.paths + ("file/fsio.py", "utils/fsio.py")

#: modules where clock reads are already governed (CB108's path scope)
#: or ARE the seam / the simulator itself
_CLOCK_GOVERNED = ClockSeamRule.paths + (
    "cluster/clock.py", "utils/clock.py", "sim/", "analysis/")


def _durability_op(call: ast.Call, helper: FsioSeamRule
                   ) -> Optional[str]:
    """Description of a durability-relevant op performed by ``call``
    (an ``os.<verb>`` from CB109's verb list, or a write-mode builtin
    ``open``), else None."""
    chain = attr_chain(call.func)
    if chain.startswith("os."):
        verb = chain[3:].split(".", 1)[0]
        if verb in helper.OS_VERBS:
            return f"{chain}()"
        return None
    if chain == "open":
        mode = helper._mode_of(call)
        if any(c in mode for c in "wax+"):
            return f"write-mode open({mode!r})"
    return None


class FsioEscapeRule(Rule):
    """CB301 — no durability op off-seam anywhere a durability root can
    reach.

    Crash consistency is machine-proven, not prose: the
    harness replays the op stream ``file/fsio.py`` records, so a
    mutation that bypasses the seam is invisible to every crash-at-op-k
    image.  CB109 guards the five storage modules by path; this rule
    walks the call graph from the durability roots and applies the same
    test to every *reachable* function in every other module, so a
    refactor that extracts ``os.replace`` into a utils/ helper cannot
    silently step off the seam.  Fix: route the op through
    ``fsio.open/replace/fsync/...``; a deliberate off-seam site
    records why with ``# lint: fsio-escape-ok <reason>``.
    """

    id = "CB301"
    slug = "fsio-escape"
    description = ("durability-root-reachable code must do filesystem "
                   "mutations through the file/fsio.py seam")
    project = True

    def check(self, sf) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError("project rule: use check_project")

    def check_project(self, sfs, ctx) -> Iterator[tuple]:
        helper = FsioSeamRule()
        roots = ctx.resolve_roots(DURABILITY_ROOTS)
        if not roots:
            return
        for info in ctx.reachable_infos(roots):
            rel = info.rel
            if rel.startswith(_FSIO_GOVERNED) \
                    or rel.startswith("analysis/"):
                continue
            for node in iter_body_nodes(info.node):
                if not isinstance(node, ast.Call):
                    continue
                desc = _durability_op(node, helper)
                if desc is not None:
                    yield (rel, node.lineno, node.col_offset,
                           f"{desc} in {info.qualname}() is reachable "
                           "from a durability root (slab append/"
                           "compact, publish, metadata write, repair "
                           "rewrite) but bypasses the filesystem seam "
                           "— the crash harness cannot record or "
                           "replay it; route through file/fsio.py or "
                           "justify with `# lint: fsio-escape-ok "
                           "<reason>`")


class ClockEscapeRule(Rule):
    """CB302 — no wall-clock read anywhere a sim scenario can reach.

    The simulator's whole contract (same seed ⇒
    byte-identical trace) holds only if every duration on a
    scenario-reachable path resolves through the clock seam.  CB108
    polices ``cluster/``, ``file/``, ``ops/batching.py`` and
    ``obs/slo.py`` by path; this rule generalizes it to the actual
    reachable set: starting from every function in ``sim/scenario.py``
    it follows the graph into ``parallel/``, ``obs/``, ``utils/`` —
    wherever the scenarios really go — and flags direct
    ``time.monotonic()``-family reads and ``loop.time()`` there.
    Deliberate wall-clock sites (profiling of real thread work, which
    the virtual loop gives zero width by design) record why with
    ``# lint: clock-escape-ok <reason>``.
    """

    id = "CB302"
    slug = "clock-escape"
    description = ("sim-scenario-reachable code must read time through "
                   "the clock seam")
    project = True

    SCENARIO_ROOTS = (("sim/scenario.py", "*"),)

    def check(self, sf) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError("project rule: use check_project")

    @staticmethod
    def _alias_tables(tree: ast.AST) -> tuple[set, dict]:
        """(time-module aliases, bare-name -> spelled time fn) — the
        CB108 alias convention, computed once per module."""
        module_aliases = {"time"}
        func_aliases: dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "time":
                        module_aliases.add(alias.asname or "time")
            elif isinstance(node, ast.ImportFrom) \
                    and node.module == "time":
                for alias in node.names:
                    if alias.name in ClockSeamRule.DIRECT_NAMES:
                        func_aliases[alias.asname or alias.name] = \
                            f"time.{alias.name}"
        return module_aliases, func_aliases

    def check_project(self, sfs, ctx) -> Iterator[tuple]:
        roots = ctx.resolve_roots(self.SCENARIO_ROOTS)
        if not roots:
            return
        tables: dict[str, tuple[set, dict]] = {}
        for info in ctx.reachable_infos(roots):
            rel = info.rel
            if rel.startswith(_CLOCK_GOVERNED):
                continue
            sf = ctx.by_rel.get(rel)
            if sf is None:
                continue
            if rel not in tables:
                tables[rel] = self._alias_tables(sf.tree)
            module_aliases, func_aliases = tables[rel]
            for node in iter_body_nodes(info.node):
                if not isinstance(node, ast.Call):
                    continue
                spelled = None
                if isinstance(node.func, ast.Name):
                    spelled = func_aliases.get(node.func.id)
                elif isinstance(node.func, ast.Attribute):
                    chain = attr_chain(node.func)
                    base, _, attr = chain.rpartition(".")
                    if base in module_aliases \
                            and attr in ClockSeamRule.DIRECT_NAMES:
                        spelled = f"{chain}()"
                    elif (node.func.attr == "time" and not node.args
                            and chain and "loop" in chain.lower()):
                        spelled = f"{chain}() (loop.time)"
                if spelled is not None:
                    yield (rel, node.lineno, node.col_offset,
                           f"direct {spelled} in {info.qualname}() is "
                           "reachable from sim/scenario.py — inside a "
                           "virtual-time run this ticks in REAL time "
                           "and skews every derived duration; route "
                           "through the clock seam (cluster/clock.py) "
                           "or justify with `# lint: clock-escape-ok "
                           "<reason>`")


def _names_in(node: ast.AST) -> set[str]:
    """Name ids and attribute tails under ``node`` — 'what does this
    expression observe', for matching cancels to their awaits."""
    out: set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.add(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.add(sub.attr)
    return out


def _suspensions(stmts) -> list[ast.AST]:
    """Suspension points executing as part of ``stmts`` themselves:
    ``await`` plus the implicit suspensions of ``async for`` /
    ``async with``; nested def/lambda subtrees excluded (their awaits
    run when THEY are called)."""
    out: list[ast.AST] = []
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        if isinstance(node, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
            out.append(node)
        stack.extend(ast.iter_child_nodes(node))
    return out


class CancelSafetyRule(Rule):
    """CB303 — cancellation must propagate, complete, and never strand
    a publish.

    Async teardown in this codebase is load-bearing: sim.run() and the
    sanitizer both require every task to finish when
    cancelled (0 leaked tasks).  Three shapes break that:

    (a) *swallowed cancellation* — ``except CancelledError:`` /
        ``except BaseException:`` / bare ``except:`` around awaits with
        no re-raise absorbs the coroutine's OWN cancellation; teardown
        then waits forever.  The sanctioned child-reap (``child.
        cancel()`` before the try, awaiting that child inside it)
        passes — there the CancelledError belongs to the child.
    (b) *cancel without await* — ``task.cancel()`` only REQUESTS
        cancellation; until the task is awaited (or gathered) it may
        still be mid-finally holding locks and file handles.  Every
        cancel of a task variable needs a later await/gather that
        observes it (directly or through the collection it came from).
    (c) *unshielded await inside a publish window* — between a
        finished write and its ``replace`` an arriving cancellation
        strands the temp file and skips the publish; wrap the window
        in ``asyncio.shield`` or keep it await-free (the
        ``_publish_atomically`` shape).

    Justified sites record why with ``# lint: cancel-safety-ok
    <reason>``.
    """

    id = "CB303"
    slug = "cancel-safety"
    description = ("cancellation must be re-raised, awaited after "
                   "cancel(), and kept out of publish windows")

    #: receivers whose .cancel() needs no await: loop TimerHandles and
    #: timers complete synchronously
    _HANDLE_HINTS = ("handle", "timer")

    def applies(self, rel: str) -> bool:
        return not rel.startswith("analysis/")

    def check(self, sf) -> Iterator[Finding]:
        for fn in ast.walk(sf.tree):
            if not isinstance(fn, ast.AsyncFunctionDef):
                continue
            yield from self._check_swallowed(fn)
            yield from self._check_cancel_without_await(fn)
            yield from self._check_publish_window(fn)

    # -- (a) swallowed CancelledError --

    @staticmethod
    def _catches_cancelled(type_node) -> bool:
        if type_node is None:
            return True  # bare except
        if isinstance(type_node, ast.Tuple):
            return any(CancelSafetyRule._catches_cancelled(el)
                       for el in type_node.elts)
        chain = attr_chain(type_node)
        tail = chain.rsplit(".", 1)[-1]
        return tail in ("CancelledError", "BaseException")

    def _check_swallowed(self, fn) -> Iterator[Finding]:
        body_nodes = list(iter_body_nodes(fn))
        cancels: list[tuple[int, set[str]]] = []
        for node in body_nodes:
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "cancel"):
                cancels.append((node.lineno, _names_in(node.func.value)))
        for node in body_nodes:
            if not isinstance(node, ast.Try):
                continue
            try_susp = _suspensions(node.body)
            if not try_susp:
                continue  # nothing to interrupt: nothing swallowed
            observed = set()
            for s in try_susp:
                observed |= _names_in(s)
            for handler in node.handlers:
                if not self._catches_cancelled(handler.type):
                    continue
                if any(isinstance(n, ast.Raise)
                       for n in ast.walk(handler)):
                    continue  # re-raises on some path
                cancelled_before = set()
                for line, names in cancels:
                    if line <= handler.lineno:
                        cancelled_before |= names
                if cancelled_before & observed:
                    # the child-reap idiom: the await observes a task
                    # this function cancelled — the CancelledError
                    # being swallowed is the child's, not ours
                    continue
                shown = "bare except" if handler.type is None else \
                    f"except {ast.unparse(handler.type)}"
                yield (handler.lineno, handler.col_offset,
                       f"{shown} around awaits in async def "
                       f"{fn.name}() swallows CancelledError — the "
                       "coroutine absorbs its own cancellation and "
                       "teardown hangs (sim.run / SANITIZE leg); "
                       "re-raise it, or justify with "
                       "`# lint: cancel-safety-ok <reason>`")

    # -- (b) cancel() never awaited --

    def _check_cancel_without_await(self, fn) -> Iterator[Finding]:
        parents = _parents(fn)
        susp = [(s.lineno, _names_in(s))
                for s in _suspensions(fn.body)]
        for node in iter_body_nodes(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "cancel"
                    and isinstance(node.func.value, ast.Name)):
                continue
            recv = node.func.value.id
            if any(h in recv.lower() for h in self._HANDLE_HINTS):
                continue  # TimerHandle.cancel() completes synchronously
            watch = {recv}
            # a cancel inside `for t in tasks:` (or `for t, meta in
            # d.items():`) is observed by awaiting the collection
            # (`gather(*tasks)`) just as well as t
            cur = parents.get(node)
            while cur is not None and cur is not fn:
                if isinstance(cur, (ast.For, ast.AsyncFor)):
                    target_names = {
                        n.id for n in ast.walk(cur.target)
                        if isinstance(n, ast.Name)}
                    if recv in target_names:
                        watch |= _names_in(cur.iter)
                cur = parents.get(cur)
            if any(line >= node.lineno and (names & watch)
                   for line, names in susp):
                continue
            yield (node.lineno, node.col_offset,
                   f"{recv}.cancel() in async def {fn.name}() is never "
                   "awaited afterwards — cancellation is only "
                   "requested, the task may still be running (holding "
                   "locks/files) when this coroutine moves on; await "
                   "it (gather(..., return_exceptions=True)) or "
                   "justify with `# lint: cancel-safety-ok <reason>`")

    # -- (c) awaits inside the write->replace publish window --

    def _check_publish_window(self, fn) -> Iterator[Finding]:
        susp = _suspensions(fn.body)
        write_awaits = []
        for s in susp:
            if not isinstance(s, ast.Await) \
                    or not isinstance(s.value, ast.Call):
                continue
            tail = attr_chain(s.value.func).rsplit(".", 1)[-1]
            if "write" in tail or tail in ("flush", "fsync"):
                write_awaits.append(s)
        if not write_awaits:
            return
        replaces = [
            node for node in iter_body_nodes(fn)
            if isinstance(node, ast.Call)
            and attr_chain(node.func).rsplit(".", 1)[-1] == "replace"]
        flagged: set[int] = set()
        for rep in replaces:
            befores = [w.lineno for w in write_awaits
                       if w.lineno < rep.lineno]
            if not befores:
                continue
            window_start = max(befores)
            for s in susp:
                if s in write_awaits or s.lineno in flagged:
                    continue
                if not (window_start < s.lineno <= rep.lineno):
                    continue
                if isinstance(s, ast.Await) \
                        and isinstance(s.value, ast.Call) \
                        and attr_chain(s.value.func).rsplit(
                            ".", 1)[-1] == "shield":
                    continue
                flagged.add(s.lineno)
                yield (s.lineno, s.col_offset,
                       f"await between a finished write and replace() "
                       f"in async def {fn.name}(): a cancellation "
                       "delivered here strands the temp file and "
                       "skips the publish — keep the window "
                       "await-free (the _publish_atomically shape) or "
                       "wrap it in asyncio.shield, else justify with "
                       "`# lint: cancel-safety-ok <reason>`")


class SimPurityRule(Rule):
    """CB304 — production planes import nothing from ``sim/``.

    The seam points one way (production paths
    import NOTHING from sim/): the simulator wraps production
    machinery, never the reverse — a production module that reaches
    into ``sim/`` would couple serving behavior to the test double and
    quietly change what ships.  tests/test_torch_sim.py's subprocess pin
    proves the property at runtime for the default import closure;
    this rule proves it statically for every module INCLUDING lazy
    in-function imports, which the runtime pin only sees on the code
    paths it happens to execute.  The one sanctioned inversion — the
    ``sim:`` Location kind resolving its fabric lazily — records why
    inline with ``# lint: sim-purity-ok <reason>``.
    """

    id = "CB304"
    slug = "sim-purity"
    description = ("production modules must not import chunky_bits_tpu_torch"
                   ".sim (the seam points one way)")

    def applies(self, rel: str) -> bool:
        return not rel.startswith(("sim/", "analysis/"))

    def check(self, sf) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            hit = ""
            if isinstance(node, ast.Import):
                for alias in node.names:
                    parts = alias.name.split(".")
                    if "sim" in parts:
                        hit = f"import {alias.name}"
                        break
            elif isinstance(node, ast.ImportFrom):
                mod_parts = (node.module or "").split(".")
                if "sim" in mod_parts:
                    hit = f"from {'.' * node.level}{node.module} import"
                elif any(a.name == "sim" for a in node.names):
                    hit = (f"from {'.' * node.level}"
                           f"{node.module or ''} import sim")
            if hit:
                yield (node.lineno, node.col_offset,
                       f"{hit}: production code importing the "
                       "simulator inverts the sim seam — sim/ wraps "
                       "production machinery, never the reverse; "
                       "invert the dependency or justify with "
                       "`# lint: sim-purity-ok <reason>`")


class LabelFlowRule(Rule):
    """CB305 — closed-set label discipline, one call hop deep.

    CB107 lets a plain parameter name through ``.labels()`` because the
    closed set may be enforced upstream — which makes the *call sites*
    the place the discipline actually holds or breaks.  This rule finds
    functions that feed a parameter into ``.labels()`` and applies
    CB107's open-endedness test (f-string / string-building / call
    result / request-derived chain) to the argument each recorded call
    site passes for that parameter.  Findings land at the call site —
    that is where the open-ended value enters the metrics plane — and
    clamp-at-the-caller is the fix, same as CB107; a provably-closed
    dynamic value records why with ``# lint: label-flow-ok <reason>``.
    """

    id = "CB305"
    slug = "label-flow"
    description = ("arguments feeding metric label parameters must be "
                   "closed-set at every call site")
    project = True

    def check(self, sf) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError("project rule: use check_project")

    def check_project(self, sfs, ctx) -> Iterator[tuple]:
        graph = ctx.graph
        judge = MetricLabelCardinalityRule()
        seen: set[tuple] = set()
        for key, info in sorted(graph.functions.items()):
            if info.rel.startswith("analysis/") \
                    or isinstance(info.node, ast.Lambda):
                continue
            args = info.node.args
            pos_params = [a.arg for a in (list(args.posonlyargs)
                                          + list(args.args))]
            all_params = set(pos_params) | {
                a.arg for a in args.kwonlyargs}
            label_params: list[str] = []
            for node in iter_body_nodes(info.node):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "labels"):
                    for val in list(node.args) + [kw.value for kw
                                                  in node.keywords]:
                        if isinstance(val, ast.Name) \
                                and val.id in all_params:
                            label_params.append(val.id)
            if not label_params:
                continue
            bound_offset = 1 if (info.cls is not None and pos_params
                                 and pos_params[0] in ("self", "cls")) \
                else 0
            for caller_key, call in graph.call_sites.get(key, ()):
                for pname in label_params:
                    arg_node = None
                    if pname in pos_params:
                        idx = pos_params.index(pname)
                        cidx = idx - bound_offset \
                            if isinstance(call.func, ast.Attribute) \
                            else idx
                        if 0 <= cidx < len(call.args):
                            arg_node = call.args[cidx]
                    for kw in call.keywords:
                        if kw.arg == pname:
                            arg_node = kw.value
                    if arg_node is None:
                        continue
                    why = judge._open_ended(arg_node)
                    if not why:
                        continue
                    mark = (caller_key[0], arg_node.lineno,
                            arg_node.col_offset, pname)
                    if mark in seen:
                        continue
                    seen.add(mark)
                    yield (caller_key[0], arg_node.lineno,
                           arg_node.col_offset,
                           f"argument for metric label parameter "
                           f"'{pname}' of {info.qualname}() is {why}: "
                           "one hop later it becomes a label value — "
                           "clamp to a closed set at this call site, "
                           "or justify with `# lint: label-flow-ok "
                           "<reason>`")


FLOW_RULES: tuple[Rule, ...] = (
    FsioEscapeRule(),
    ClockEscapeRule(),
    CancelSafetyRule(),
    SimPurityRule(),
    LabelFlowRule(),
)
