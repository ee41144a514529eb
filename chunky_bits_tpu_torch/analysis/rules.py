"""The project-native lint rules.

Each rule pins one invariant of the port (the reference's CLAUDE.md
and ROADMAP.md's rules for the port) to AST shape.  They are
heuristics with an escape hatch by design: an inline
``# lint: <slug>-ok <reason>`` records WHY a flagged site is safe, so
the justification lives next to the code it excuses and shows up in
review when either changes.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

#: path prefixes of the device/network call paths — the routes where an
#: unbounded wait or a non-daemon worker can hang a serve or block exit
#: (file_part.py, destination.py and health.py joined with the hedged
#: I/O scheduler: every await the read race / write failover adds must
#: stay reachable through a timeout; slab.py, scrub.py and repair.py
#: joined with the packed store + scrub daemon + repair planner: a
#: long-running background walker is exactly the shape that hangs a
#: shutdown if any wait is unbounded)
#: obs/ rides along: the metrics/tracing plane is called from every
#: serve path, so a blocking or unbounded wait there stalls the same
#: loops the rest of this list protects
DEVICE_NET_PATHS = ("ops/", "parallel/", "gateway/", "obs/",
                    "file/chunk_cache.py",
                    "file/file_part.py", "file/slab.py",
                    "cluster/destination.py", "cluster/health.py",
                    "cluster/scrub.py", "cluster/repair.py",
                    "cluster/meta_log.py", "cluster/qos.py")

ENV_PREFIX = "CHUNKY_BITS_TORCH_"

#: the one module allowed to read CHUNKY_BITS_TORCH_* from the process
#: environment; everything else goes through its accessors
ENV_HOME = "cluster/tunables.py"

#: the strict-typing public surfaces (mirrors the [tool.mypy] overrides
#: in pyproject.toml, which enforce the same set when mypy is installed)
STRICT_TYPED_MODULES = (
    "ops/backend.py",
    "file/chunk_cache.py",
    "cluster/tunables.py",
    "file/file_part.py",
    "parallel/backend.py",
)

Finding = tuple[int, int, str]


def rule_family(rule_id: str) -> str:
    """Family id for a rule id ('CB101' -> 'CB1xx') — the ONE place the
    derivation lives; ``Rule.family`` and the CLI's --json
    ``rule_family`` field both come through here."""
    return f"{rule_id[:3]}xx"


class Rule:
    id: str = ""
    slug: str = ""
    description: str = ""
    #: rel-path prefixes the rule applies to; () = every file
    paths: tuple[str, ...] = ()
    #: project rules see every parsed file at once via
    #: ``check_project(sfs)`` (interprocedural passes — see core.py)
    project: bool = False

    @property
    def family(self) -> str:
        """Rule family id, 'CB1xx' / 'CB2xx' (the --select prefix and
        the --json ``rule_family`` field)."""
        return rule_family(self.id)

    def applies(self, rel: str) -> bool:
        if not self.paths:
            return True
        return any(rel == p or rel.startswith(p) for p in self.paths)

    def check(self, sf) -> Iterator[Finding]:
        raise NotImplementedError


def _attr_chain(node: ast.AST) -> str:
    """Dotted name for Name/Attribute chains ('os.environ.get'), or ''."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    par: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            par[child] = node
    return par


class UnboundedAwaitRule(Rule):
    """CB101 — never hang.

    On device/network call paths every wait must be bounded: a stuck
    device call or a dead peer otherwise hangs the serve forever.  Flags ``await``
    on bare futures/tasks and on the known-unbounded wait primitives
    (``.wait()``, ``.wait_closed()``, ``.join()``, ``.serve_forever()``,
    ``run_in_executor``).  Bounded alternatives: ``asyncio.wait_for``,
    or a liveness argument recorded via
    ``# lint: unbounded-await-ok <reason>``.
    """

    id = "CB101"
    slug = "unbounded-await"
    description = ("await on device/network paths must be reachable "
                   "through a timeout guard")
    paths = DEVICE_NET_PATHS

    WATCH = ("wait", "wait_closed", "join", "serve_forever",
             "run_in_executor")

    def check(self, sf) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Await):
                continue
            value = node.value
            if isinstance(value, (ast.Name, ast.Attribute)):
                yield (node.lineno, node.col_offset,
                       "await on a bare future/task is unbounded; wrap "
                       "in asyncio.wait_for or justify with "
                       "`# lint: unbounded-await-ok <reason>`")
            elif (isinstance(value, ast.Call)
                    and isinstance(value.func, ast.Attribute)
                    and value.func.attr in self.WATCH):
                yield (node.lineno, node.col_offset,
                       f"await .{value.func.attr}() has no deadline; "
                       "wrap in asyncio.wait_for or justify with "
                       "`# lint: unbounded-await-ok <reason>`")


class EnvFlagDisciplineRule(Rule):
    """CB102 — flags are read at first dispatch and baked into
    built kernels and cached backends, so scattered ad-hoc reads make 'where is this
    knob read, and when' unanswerable.  All ``CHUNKY_BITS_TORCH_*``
    environment reads go through cluster/tunables.py accessors
    (``env_flag`` / ``env_seconds`` / ``env_str``); a deliberate
    first-dispatch read elsewhere carries
    ``# lint: env-read-ok <reason>``.  Writes (the CLI's backend
    handoff) are out of scope — the hazard is read placement.
    """

    id = "CB102"
    slug = "env-read"
    description = ("CHUNKY_BITS_TORCH_* environment reads belong in "
                   "cluster/tunables.py accessors")

    def applies(self, rel: str) -> bool:
        return rel != ENV_HOME and not rel.startswith("analysis/")

    def _key_of(self, sf, node: ast.AST) -> str:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return sf.constants.get(node.id, "")
        return ""

    def check(self, sf) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            key = ""
            if isinstance(node, ast.Call):
                chain = _attr_chain(node.func)
                if chain in ("os.environ.get", "environ.get",
                             "os.environ.setdefault",
                             "environ.setdefault",
                             "os.getenv", "getenv") and node.args:
                    key = self._key_of(sf, node.args[0])
            elif (isinstance(node, ast.Subscript)
                    and isinstance(node.ctx, ast.Load)
                    and _attr_chain(node.value) in ("os.environ",
                                                    "environ")):
                key = self._key_of(sf, node.slice)
            if key.startswith(ENV_PREFIX):
                yield (node.lineno, node.col_offset,
                       f"direct read of ${key}: route through "
                       "cluster/tunables.py accessors (env_flag/"
                       "env_seconds/env_str) or justify a designated "
                       "first-dispatch site with "
                       "`# lint: env-read-ok <reason>`")


class NonDaemonThreadRule(Rule):
    """CB103 — ThreadPoolExecutor workers are non-daemon and join at
    interpreter exit, so one worker parked inside a device call blocks
    exit forever.  Device-wait paths use plain
    ``threading.Thread(daemon=True)``; a pool that provably never
    touches the device records that with ``# lint: thread-ok <reason>``.
    """

    id = "CB103"
    slug = "thread"
    description = ("no ThreadPoolExecutor / non-daemon Thread on "
                   "device-wait paths")
    paths = ("ops/", "parallel/")

    def check(self, sf) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            tail = chain.rsplit(".", 1)[-1]
            if tail == "ThreadPoolExecutor":
                yield (node.lineno, node.col_offset,
                       "ThreadPoolExecutor on a device-wait path: its "
                       "non-daemon workers block interpreter exit when "
                       "parked in a device call — use threading.Thread("
                       "daemon=True) or justify with "
                       "`# lint: thread-ok <reason>`")
            elif tail == "Thread" and chain in ("Thread",
                                                "threading.Thread"):
                daemon_true = any(
                    kw.arg == "daemon"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in node.keywords)
                if not daemon_true:
                    yield (node.lineno, node.col_offset,
                           "non-daemon Thread on a device-wait path "
                           "blocks interpreter exit when parked in "
                           "a device call; pass daemon=True or justify with "
                           "`# lint: thread-ok <reason>`")


class BroadExceptRule(Rule):
    """CB104 — degraded-mode fallbacks must not silently eat corruption
    signals.  ``except Exception`` (or broader) is allowed only when it
    (a) ends in a ``raise`` (nothing can be swallowed), or (b) carries a
    ``# lint: broad-except-ok <reason>`` justification — so every
    swallow-and-continue site states what it degrades to and why that
    cannot hide corruption.  ``# noqa: BLE001 <reason>`` is accepted as
    the same marker.
    """

    id = "CB104"
    slug = "broad-except"
    description = ("broad except handlers must re-raise or carry a "
                   "justification")

    BROAD = ("Exception", "BaseException")

    def _is_broad(self, type_node) -> bool:
        if type_node is None:
            return True  # bare except:
        if isinstance(type_node, ast.Name):
            return type_node.id in self.BROAD
        if isinstance(type_node, ast.Tuple):
            return any(self._is_broad(el) for el in type_node.elts)
        return False

    def check(self, sf) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if not self._is_broad(node.type):
                continue
            if node.body and isinstance(node.body[-1], ast.Raise):
                continue  # terminal re-raise: cannot swallow
            shown = "bare except" if node.type is None else \
                f"except {ast.unparse(node.type)}"
            yield (node.lineno, node.col_offset,
                   f"{shown} without a terminal raise can swallow "
                   "corruption signals; narrow the type or justify "
                   "with `# lint: broad-except-ok <reason>`")


class LaunchHygieneRule(Rule):
    """CB105 — a hand-written kernel trusts the pointers and the return
    code it is given, and nothing checks them for it.  Three launch
    shapes in ``ops/`` and ``parallel/`` hide a fault instead of raising:

    * ``.data_ptr()`` of a tensor that was neither made ``.contiguous()``
      nor allocated (``torch.empty*``/``zeros*``/``new_empty``/
      ``new_zeros``) in the same function.  The CUDA kernels read raw
      pointers as dense rows, so a strided view gives wrong bytes with
      no error (the model sites: ``ops/gf_kernel.py::_launch`` and
      ``reduce_pack``);
    * a call to a kernel entry obtained from ``_library(...)`` whose
      return code is discarded: a failed launch would pass as a result,
      and the port has no fallback to catch it;
    * an in-place write (``.copy_``, any ``*_`` method, ``out=``,
      subscript or augmented assignment) to a tensor made by
      ``torch.from_numpy(...)`` in the same function.  It shares the
      array's memory, so the write lands in the caller's buffer.

    A site that is safe for a reason the AST cannot see records it with
    ``# lint: launch-hygiene-ok <reason>``.
    """

    id = "CB105"
    slug = "launch-hygiene"
    description = ("kernel launches take dense tensors and check their "
                   "return code; from_numpy tensors stay read-only")
    paths = ("ops/", "parallel/")

    #: call-name tails that allocate a fresh, dense tensor
    ALLOC_PREFIXES = ("empty", "zeros", "new_empty", "new_zeros")

    def _dense(self, node: ast.AST) -> bool:
        """True for an expression that yields a dense tensor (or None):
        ``x.contiguous()``, an allocation, or a conditional of those."""
        if isinstance(node, ast.Constant) and node.value is None:
            return True
        if isinstance(node, ast.IfExp):
            return self._dense(node.body) and self._dense(node.orelse)
        if not isinstance(node, ast.Call):
            return False
        tail = _attr_chain(node.func).rsplit(".", 1)[-1] \
            if not isinstance(node.func, ast.Attribute) else node.func.attr
        return tail == "contiguous" or tail.startswith(self.ALLOC_PREFIXES)

    @staticmethod
    def _is_from_numpy(node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and _attr_chain(node.func) in ("torch.from_numpy",
                                               "from_numpy"))

    @staticmethod
    def _is_library(node: ast.AST) -> bool:
        return (isinstance(node, ast.Call)
                and _attr_chain(node.func).rsplit(".", 1)[-1] == "_library")

    def _bindings(self, fn: ast.AST) -> tuple[set, set, set, set]:
        """Names bound in ``fn``: dense tensors, lists of dense tensors,
        kernel entries from ``_library`` and ``from_numpy`` tensors."""
        dense: set[str] = set()
        dense_lists: set[str] = set()
        kernels: set[str] = set()
        aliased: set[str] = set()
        for node in self._own_nodes(fn):
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets, value = [node.target], node.value
            else:
                continue
            for target in targets:
                if isinstance(target, ast.Name):
                    if self._dense(value):
                        dense.add(target.id)
                    elif (isinstance(value, (ast.ListComp,
                                             ast.GeneratorExp))
                            and self._dense(value.elt)):
                        dense_lists.add(target.id)
                    elif self._is_library(value):
                        kernels.add(target.id)
                    elif self._is_from_numpy(value):
                        aliased.add(target.id)
                elif (isinstance(target, ast.Tuple) and target.elts
                        and isinstance(target.elts[0], ast.Name)
                        and self._is_library(value)):
                    # fn, error_string = _library(name)
                    kernels.add(target.elts[0].id)
        return dense, dense_lists, kernels, aliased

    def _dense_receiver(self, node: ast.AST, dense: set,
                        comp_vars: set) -> bool:
        if isinstance(node, ast.Name):
            return node.id in dense or node.id in comp_vars
        return self._dense(node)

    _DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)

    def check(self, sf) -> Iterator[Finding]:
        empty: tuple[set, set, set, set] = (set(), set(), set(), set())
        for node in self._own_nodes(sf.tree):
            if isinstance(node, self._DEFS):
                yield from self._check_function(node, empty)

    def _own_nodes(self, top: ast.AST) -> Iterator[ast.AST]:
        """Every node under ``top`` down to and including the next
        nested defs, whose bodies are checked as functions of their
        own."""
        stack = list(ast.iter_child_nodes(top))
        while stack:
            node = stack.pop()
            yield node
            if not isinstance(node, self._DEFS):
                stack.extend(ast.iter_child_nodes(node))

    def _check_function(self, fn: ast.AST,
                        outer: tuple[set, set, set, set]
                        ) -> Iterator[Finding]:
        # a closure sees the bindings of the functions around it
        dense, dense_lists, kernels, aliased = (
            a | b for a, b in zip(outer, self._bindings(fn)))
        for node in self._own_nodes(fn):
            if isinstance(node, self._DEFS):
                yield from self._check_function(
                    node, (dense, dense_lists, kernels, aliased))
        # comprehension variables that iterate over a dense list
        comp_vars = set()
        for node in self._own_nodes(fn):
            if isinstance(node, ast.comprehension) \
                    and isinstance(node.target, ast.Name) \
                    and isinstance(node.iter, ast.Name) \
                    and node.iter.id in dense_lists:
                comp_vars.add(node.target.id)
        for node in self._own_nodes(fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                attr = node.func.attr
                recv = node.func.value
                if attr == "data_ptr" and not self._dense_receiver(
                        recv, dense, comp_vars):
                    shown = ast.unparse(recv)
                    yield (node.lineno, node.col_offset,
                           f"{shown}.data_ptr() of a tensor not made "
                           ".contiguous() or allocated in this function: "
                           "a strided view hands the kernel wrong bytes "
                           "silently; call .contiguous() first or "
                           "justify with `# lint: launch-hygiene-ok "
                           "<reason>`")
                elif (attr.endswith("_") and not attr.startswith("_")
                        and ((isinstance(recv, ast.Name)
                              and recv.id in aliased)
                             or self._is_from_numpy(recv))):
                    yield (node.lineno, node.col_offset,
                           f"in-place .{attr}() on a torch.from_numpy "
                           "tensor writes into the caller's array; copy "
                           "first or justify with `# lint: "
                           "launch-hygiene-ok <reason>`")
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if (kw.arg == "out" and isinstance(kw.value, ast.Name)
                            and kw.value.id in aliased):
                        yield (node.lineno, node.col_offset,
                               f"out={kw.value.id} is a torch.from_numpy "
                               "tensor: the result lands in the caller's "
                               "array; copy first or justify with "
                               "`# lint: launch-hygiene-ok <reason>`")
            elif isinstance(node, ast.Expr) \
                    and isinstance(node.value, ast.Call):
                func = node.value.func
                base = func.value if isinstance(func, ast.Attribute) \
                    else func
                if isinstance(base, ast.Name) and base.id in kernels:
                    yield (node.lineno, node.col_offset,
                           f"return code of kernel entry "
                           f"{ast.unparse(func)}() discarded: a failed "
                           "launch passes as a result; check it and "
                           "raise ErasureError, or justify with "
                           "`# lint: launch-hygiene-ok <reason>`")
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for target in targets:
                    if isinstance(node, ast.AugAssign) \
                            and isinstance(target, ast.Name):
                        name = target.id
                    elif isinstance(target, ast.Subscript) \
                            and isinstance(target.value, ast.Name):
                        name = target.value.id
                    else:
                        continue
                    if name in aliased:
                        yield (node.lineno, node.col_offset,
                               f"in-place write to {name}, a "
                               "torch.from_numpy tensor: it lands in the "
                               "caller's array; copy first or justify "
                               "with `# lint: launch-hygiene-ok "
                               "<reason>`")


class PublicAnnotationsRule(Rule):
    """CB106 — the runnable half of the strict typing gate: the public
    surfaces listed in ``STRICT_TYPED_MODULES`` must carry full
    parameter and return annotations.  mypy (when installed) enforces
    consistency; this rule enforces presence
    even on boxes without mypy, so the tier-1 gate never silently loses
    the typing floor.
    """

    id = "CB106"
    slug = "annotations"
    description = ("public functions on strict-typed modules need full "
                   "annotations")
    paths = STRICT_TYPED_MODULES

    def applies(self, rel: str) -> bool:
        return rel in self.paths

    def check(self, sf) -> Iterator[Finding]:
        def check_fn(fn, is_method: bool) -> Iterator[Finding]:
            if fn.name.startswith("_"):
                return
            args = fn.args
            named = (list(args.posonlyargs) + list(args.args)
                     + list(args.kwonlyargs))
            if is_method and named and named[0].arg in ("self", "cls"):
                named = named[1:]
            missing = [a.arg for a in named if a.annotation is None]
            for extra in (args.vararg, args.kwarg):
                if extra is not None and extra.annotation is None:
                    missing.append(f"*{extra.arg}")
            if missing:
                yield (fn.lineno, fn.col_offset,
                       f"public {'method' if is_method else 'function'} "
                       f"{fn.name}() missing parameter annotations: "
                       f"{', '.join(missing)} (strict typing gate)")
            if fn.returns is None:
                yield (fn.lineno, fn.col_offset,
                       f"public {'method' if is_method else 'function'} "
                       f"{fn.name}() missing a return annotation "
                       "(strict typing gate)")

        for node in sf.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from check_fn(node, is_method=False)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        is_static = any(
                            isinstance(d, ast.Name)
                            and d.id == "staticmethod"
                            for d in sub.decorator_list)
                        yield from check_fn(sub,
                                            is_method=not is_static)


class MetricLabelCardinalityRule(Rule):
    """CB107 — metric label values must come from closed sets
    (obs/metrics.py's cardinality rule): a label minted from a request
    path, a client header, or any other open-ended string grows one
    time series per distinct value — an unbounded memory leak and a
    scrape bomb.  Flags ``.labels(...)`` arguments that are f-strings,
    string-building expressions, call results, or request-derived
    attribute chains; plain literals and names (bound upstream to
    clamped/closed values) pass.  The registry's MAX_LABEL_SETS ceiling
    is the runtime backstop; a provably-closed dynamic value records
    its argument with ``# lint: label-cardinality-ok <reason>``.
    """

    id = "CB107"
    slug = "label-cardinality"
    description = ("metric label values must come from closed sets, "
                   "never request-derived strings")

    #: attribute chains that scream "request-derived"
    TAINTED = ("request.", "req.")
    TAINTED_ATTRS = ("path", "query_string", "rel_url", "match_info",
                     "headers")

    def _open_ended(self, node: ast.AST) -> str:
        if isinstance(node, ast.JoinedStr):
            return "an f-string"
        if isinstance(node, ast.BinOp):
            return "a string-building expression"
        if isinstance(node, ast.Call):
            return "a call result"
        chain = _attr_chain(node)
        if chain:
            if any(chain.startswith(t) for t in self.TAINTED):
                return f"request-derived ({chain})"
            tail = chain.rsplit(".", 1)[-1]
            if "." in chain and tail in self.TAINTED_ATTRS:
                return f"request-derived ({chain})"
        return ""

    def check(self, sf) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "labels"):
                continue
            values = list(node.args) + [kw.value for kw in node.keywords]
            for val in values:
                why = self._open_ended(val)
                if why:
                    yield (val.lineno, val.col_offset,
                           f"metric label value is {why}: label values "
                           "must come from a closed set (clamp first, "
                           "like obs/metrics.record_request), or "
                           "justify with `# lint: label-cardinality-ok "
                           "<reason>`")


class ClockSeamRule(Rule):
    """CB108 — the clock seam cannot silently rot.

    Every time-sensitive policy in the cluster/file planes (EWMA decay,
    breaker cooldowns, token buckets, hedge delays, retry backoff, I/O
    latency samples) resolves time through ``cluster/clock.py`` (the
    seam ``utils/clock.py`` implements), so the
    deterministic cluster simulator (``sim/``) can swap
    in a virtual clock and compress hours of scenario into seconds.  A
    direct ``time.monotonic()`` / ``time.time()`` / ``loop.time()``
    read in ``cluster/``, ``file/``, ``ops/batching.py`` or
    ``obs/slo.py`` (the SLO engine's window arithmetic MUST compress
    with the scenario it observes, or detection latency would be
    measured on the wrong timebase) would tick in REAL time inside a
    virtual-time run — every duration touching it silently corrupts.
    Justified wall-clock sites (human-facing timestamps like slab
    publish stamps) carry ``# lint: clock-ok <reason>``; the seam
    module itself is the one sanctioned home for direct reads.
    """

    id = "CB108"
    slug = "clock"
    description = ("cluster/file-plane time reads go through the "
                   "cluster/clock.py seam")
    paths = ("cluster/", "file/", "ops/batching.py", "obs/slo.py")

    #: the clock-read function names (incl. the nanosecond spellings —
    #: a ns read mixes timebases just as silently); alias-import
    #: tracking follows the CB102 convention: `from time import
    #: monotonic` and `import time as t` must not slip past the lint
    DIRECT_NAMES = ("monotonic", "time", "perf_counter",
                    "monotonic_ns", "time_ns", "perf_counter_ns")

    #: direct stdlib reads that bypass the seam outright
    DIRECT = tuple(f"time.{name}" for name in DIRECT_NAMES)

    def applies(self, rel: str) -> bool:
        return rel != "cluster/clock.py" and super().applies(rel)

    @staticmethod
    def _is_loop_call(value: ast.AST) -> bool:
        """True when ``value`` is a call that yields an event loop
        (``asyncio.get_running_loop()`` / ``get_event_loop()`` /
        ``new_event_loop()``) — the call-result spelling of
        ``loop.time()``."""
        if not isinstance(value, ast.Call):
            return False
        callee = _attr_chain(value.func)
        return callee.rsplit(".", 1)[-1] in (
            "get_running_loop", "get_event_loop", "new_event_loop")

    def check(self, sf) -> Iterator[Finding]:
        # alias imports first, so renamed spellings can't slip past:
        # `import time as t` -> t.monotonic(); `from time import
        # monotonic [as m]` -> bare monotonic()/m()
        module_aliases = {"time"}
        func_aliases: dict[str, str] = {}
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name == "time":
                        module_aliases.add(alias.asname or "time")
            elif isinstance(node, ast.ImportFrom) \
                    and node.module == "time":
                for alias in node.names:
                    if alias.name in self.DIRECT_NAMES:
                        func_aliases[alias.asname or alias.name] = \
                            f"time.{alias.name}"
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            if isinstance(node.func, ast.Name):
                spelled = func_aliases.get(node.func.id)
                if spelled is not None:
                    yield (node.lineno, node.col_offset,
                           f"direct {spelled}() (imported as "
                           f"{node.func.id}) bypasses the clock seam "
                           "— route through clock.monotonic() or "
                           "justify with `# lint: clock-ok <reason>`")
                continue
            if not isinstance(node.func, ast.Attribute):
                continue
            chain = _attr_chain(node.func)
            base, _, attr = chain.rpartition(".")
            if chain in self.DIRECT or (
                    base in module_aliases
                    and attr in self.DIRECT_NAMES):
                yield (node.lineno, node.col_offset,
                       f"direct {chain}() bypasses the clock seam "
                       "(cluster/clock.py; file/ modules import "
                       "chunky_bits_tpu_torch.utils.clock) — a virtual-time "
                       "run would silently mix timebases; route "
                       "through clock.monotonic() or justify with "
                       "`# lint: clock-ok <reason>`")
            elif (node.func.attr == "time" and not node.args
                    and chain != "time.time"
                    and ("loop" in chain.lower() if chain
                         else self._is_loop_call(node.func.value))):
                # loop.time() in any spelling: a named loop variable
                # or a get_running_loop()/get_event_loop() call result
                # (an arbitrary call result — datetime.now().time() —
                # is NOT a loop and must not force a bogus suppression)
                yield (node.lineno, node.col_offset,
                       "loop.time() bypasses the clock seam — on the "
                       "simulator's loop it happens to be virtual, but "
                       "production durations must come off ONE clock "
                       "(clock.monotonic()); justify deliberate sites "
                       "with `# lint: clock-ok <reason>`")


class FsioSeamRule(Rule):
    """CB109 — the filesystem seam cannot silently rot.

    Every durability-relevant op on the storage plane — slab append +
    journal commit, compaction swap, atomic chunk/metadata
    publication, the repair planner's in-place rewrites — resolves
    through ``file/fsio.py`` (the seam ``utils/fsio.py``
    implements), so the crash-consistency harness
    (``sim/crash.py``) can record the exact op stream
    of a mutation and replay every "crash at op k" prefix into a
    cloned directory.  A direct ``os.replace``/``os.fsync``/
    ``os.unlink``/write-mode ``open`` (and friends) in the storage
    modules would mutate disk state INVISIBLY to the recorder — the
    crash matrix would go green while skipping the very op that tears.
    Deliberate off-seam sites (read-side probes, lock files) carry
    ``# lint: fsio-ok <reason>``; the seam modules themselves are the
    sanctioned homes for direct calls.
    """

    id = "CB109"
    slug = "fsio"
    description = ("storage-plane durability ops go through the "
                   "file/fsio.py seam")
    paths = ("file/slab.py", "file/location.py", "cluster/metadata.py",
             "cluster/meta_log.py", "cluster/repair.py",
             "cluster/scrub.py")

    #: the os-level durability verbs the seam wraps (os.rename rides
    #: along: it is os.replace minus the overwrite guarantee)
    OS_VERBS = ("replace", "rename", "fsync", "unlink", "remove",
                "truncate", "ftruncate", "makedirs", "mkdir", "rmdir",
                "open", "write")

    def _mode_of(self, node: ast.Call) -> str:
        """The literal mode argument of a builtin-open call, or ''."""
        mode_node: Optional[ast.AST] = None
        if len(node.args) >= 2:
            mode_node = node.args[1]
        for kw in node.keywords:
            if kw.arg == "mode":
                mode_node = kw.value
        if isinstance(mode_node, ast.Constant) \
                and isinstance(mode_node.value, str):
            return mode_node.value
        return ""

    def check(self, sf) -> Iterator[Finding]:
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain.startswith("os."):
                verb = chain[3:].split(".", 1)[0]
                if verb in self.OS_VERBS:
                    yield (node.lineno, node.col_offset,
                           f"direct {chain}() bypasses the filesystem "
                           "seam — the crash harness cannot record or "
                           "replay this mutation; route through "
                           "file/fsio.py (fsio.replace/fsio.fsync/"
                           "fsio.open/...) or justify with "
                           "`# lint: fsio-ok <reason>`")
            elif chain == "open":
                mode = self._mode_of(node)
                if any(c in mode for c in "wax+"):
                    yield (node.lineno, node.col_offset,
                           f"write-mode open({mode!r}) bypasses the "
                           "filesystem seam — the crash harness cannot "
                           "record or replay this mutation; use "
                           "fsio.open or justify with "
                           "`# lint: fsio-ok <reason>`")


#: one-line hazard descriptions for --list-rules family grouping
FAMILY_HAZARDS = {
    "CB1xx": ("single-function invariants: bounded waits, env-flag "
              "discipline, daemon threads, narrow excepts, launch "
              "hygiene, typing floor, metric label cardinality, "
              "clock-seam discipline, filesystem-seam discipline"),
    "CB2xx": ("concurrency hazards of the two-plane host/async "
              "runtime: blocked loops, cross-plane handoffs, leaked "
              "tasks, loop-spanning shared state"),
    "CB3xx": ("whole-program reachability: seam escapes beyond the "
              "CB108/CB109 path lists, cancellation safety, sim-plane "
              "purity, label flow across call sites — all over the "
              "function-granular call graph (analysis/callgraph.py)"),
    "CB4xx": ("resource lifetime & deadline propagation over "
              "statement-granular CFGs with exception/finally/"
              "cancellation edges (analysis/cfg.py) and gen/kill "
              "dataflow, summaries composed through the call graph: "
              "handles closed on every path, locks always released, "
              "tasks always owned, awaits bounded at some frame, "
              "scrub/repair I/O charged before it happens"),
}

# imported at the bottom: concurrency.py, flow.py and lifetime.py need
# Rule defined first
from chunky_bits_tpu_torch.analysis.concurrency import (  # noqa: E402
    CONCURRENCY_RULES,
)
from chunky_bits_tpu_torch.analysis.flow import FLOW_RULES  # noqa: E402
from chunky_bits_tpu_torch.analysis.lifetime import (  # noqa: E402
    LIFETIME_RULES,
)

ALL_RULES: tuple[Rule, ...] = (
    UnboundedAwaitRule(),
    EnvFlagDisciplineRule(),
    NonDaemonThreadRule(),
    BroadExceptRule(),
    LaunchHygieneRule(),
    PublicAnnotationsRule(),
    MetricLabelCardinalityRule(),
    ClockSeamRule(),
    FsioSeamRule(),
) + CONCURRENCY_RULES + FLOW_RULES + LIFETIME_RULES
