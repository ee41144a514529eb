"""Statement-granular control-flow graphs + forward dataflow (CB4xx).

The CB1xx-CB3xx families reason over raw ASTs and a call graph with no
notion of control flow, so "released on ALL paths, including the
exception and cancellation paths" — the exact shape of the reference's
``to_thread(open)`` orphaned-fd leak and of its unreaped reader
tasks, and of the "degrade, never hang" invariant — was the one class
of invariant the linter could not machine-check.  This module
is the missing compiler layer: intra-function CFGs over stdlib ``ast``
alone (no device needed, like the rest of ``analysis/``)
plus a small forward must/may dataflow engine the CB4xx rules
(``analysis/lifetime.py``) instantiate with rule-specific gen/kill
sets.

Graph shape
-----------

One node per *statement* (plus synthetic entry/exit/raise-exit and
per-``try`` dispatch/finally-pad nodes).  Edges come in two kinds:

- **flow** — ordinary sequencing, branching, loop back edges;
- **exc**  — a statement that may raise transfers control to the
  innermost handler frame (its ``try``'s except-dispatch node, else the
  enclosing ``finally``, else the function's exceptional exit).  A
  statement "may raise" when its own subtree (nested ``def``/``lambda``
  bodies excluded) contains a call, an ``await``, a ``raise``/
  ``assert``, or is a loop/``with`` header (``__iter__``/``__enter__``
  can raise).  *Every await is a cancellation point* — ``await``,
  ``async for`` and ``async with`` may raise ``CancelledError`` at any
  suspension, so they always carry an exc edge; that is the
  await-as-cancellation-point edge the resource-lifetime rules lean on.

Deliberate simplifications (all err toward MORE paths, the safe
direction for leak detection — a may-analysis over a superset of real
paths can only over-flag, never under-flag, and the shared
``# lint: <slug>-ok`` machinery absorbs the rare excess):

- ``finally`` bodies are built once and their exits fan out to every
  continuation the block could resume (fall-through AND exception
  propagation), rather than being duplicated per continuation kind.
- ``return``/``break``/``continue`` under a ``try/finally`` edge both
  to the finally pad and directly to their target.
- exc edges transfer the statement's *pre*-state with kills applied
  but gens withheld: an acquisition that raises acquired nothing, while
  a release interrupted mid-call is still treated as released (closing
  a handle that errored while closing is not a leak worth a finding).
- ``with`` blocks assume the context manager does not suppress
  exceptions (none of ours do); the unwind itself is the body
  statements' exc edges — ``__exit__`` runs on every one of them.

Dataflow engine
---------------

:func:`dataflow` runs a forward gen/kill analysis to fixpoint over a
CFG: *may* (union meet — "does any path carry the fact here", the leak
query) or *must* (intersection meet — "do all paths carry it", the
dominance query CB405 uses for charge-before-I/O).  Facts are opaque
hashables; per-edge transfer implements the pre-state convention above.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Sequence

#: node kinds (``CFG.kinds``); synthetic nodes carry no statement
K_ENTRY = "entry"
K_EXIT = "exit"
K_RAISE = "raise-exit"
K_STMT = "stmt"
K_DISPATCH = "except-dispatch"
K_FINPAD = "finally-pad"
K_HANDLER = "handler"

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)

#: statement types that are may-raise by construction, before looking
#: for calls/awaits inside them
_RAISING_STMTS = (ast.Raise, ast.Assert, ast.With, ast.AsyncWith,
                  ast.For, ast.AsyncFor)


def stmt_expressions(stmt: ast.AST) -> list[ast.AST]:
    """The expressions evaluated AT this statement's CFG node.

    Compound statements get one node for their *header* only — the body
    statements have nodes of their own — so analyses must not credit a
    body's calls/releases to the header (or an ``except`` body's to its
    handler node, whose AST children include it).  Simple statements
    evaluate their whole subtree."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.target, stmt.iter]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return list(stmt.items)
    if isinstance(stmt, ast.Match):
        return [stmt.subject]
    if isinstance(stmt, ast.ExceptHandler):
        return [stmt.type] if stmt.type is not None else []
    if isinstance(stmt, ast.Try):
        return []
    if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []  # a nested definition's code runs when called
    return [stmt]


def _header_subtrees(stmt: ast.AST) -> Iterator[ast.AST]:
    """Walk the node's header expressions, stopping at nested
    def/lambda boundaries (their code runs when THEY are called)."""
    stack = list(stmt_expressions(stmt))
    while stack:
        cur = stack.pop()
        yield cur
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, _FUNC_NODES):
                continue
            stack.append(child)


#: Method tails that return without raising: ``Task.cancel()`` /
#: ``Handle.cancel()`` only *request* cancellation (bool/None result,
#: no exception path).  Treating the request call as raising would turn
#: every ``finally: t.cancel(); await t`` reaper — the canonical owned
#: shape — into a false exception-path leak between the two statements.
_NONRAISING_TAILS = frozenset({"cancel"})


def _never_raises(call: ast.Call) -> bool:
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr in _NONRAISING_TAILS)


def may_raise(stmt: ast.AST) -> bool:
    """Conservative "can this statement transfer control to a handler":
    any call or suspension point evaluated at this node, or a statement
    whose protocol methods can raise (see module docstring)."""
    if isinstance(stmt, _RAISING_STMTS):
        return True
    for node in _header_subtrees(stmt):
        if isinstance(node, ast.Await):
            return True
        if isinstance(node, ast.Call) and not _never_raises(node):
            return True
    return False


def is_cancellation_point(stmt: ast.AST) -> bool:
    """True when the statement suspends at this node (await in a header
    expression / async-for / async-with) — a ``CancelledError`` can
    surface here even if nothing else in the statement can fail."""
    if isinstance(stmt, (ast.AsyncFor, ast.AsyncWith)):
        return True
    for node in _header_subtrees(stmt):
        if isinstance(node, ast.Await):
            return True
    return False


class CFG:
    """One function's control-flow graph.  Nodes are indices into the
    parallel ``stmts``/``kinds`` lists; ``flow``/``exc`` hold successor
    sets per node (see module docstring for edge semantics)."""

    def __init__(self) -> None:
        self.stmts: list[Optional[ast.AST]] = []
        self.kinds: list[str] = []
        self.flow: list[set[int]] = []
        self.exc: list[set[int]] = []
        self.entry = self.add_node(K_ENTRY)
        self.exit = self.add_node(K_EXIT)
        self.raise_exit = self.add_node(K_RAISE)

    def add_node(self, kind: str,
                 stmt: Optional[ast.AST] = None) -> int:
        self.stmts.append(stmt)
        self.kinds.append(kind)
        self.flow.append(set())
        self.exc.append(set())
        return len(self.stmts) - 1

    @property
    def n_nodes(self) -> int:
        return len(self.stmts)

    @property
    def n_edges(self) -> int:
        return sum(len(s) for s in self.flow) \
            + sum(len(s) for s in self.exc)

    def node_of(self, stmt: ast.AST) -> Optional[int]:
        """Index of the node carrying ``stmt``, if any."""
        for idx, s in enumerate(self.stmts):
            if s is stmt:
                return idx
        return None

    def preds(self) -> list[list[tuple[int, bool]]]:
        """Per-node predecessor list as ``(pred, is_exc)`` pairs."""
        out: list[list[tuple[int, bool]]] = [[] for _ in self.stmts]
        for src, succs in enumerate(self.flow):
            for dst in succs:
                out[dst].append((src, False))
        for src, succs in enumerate(self.exc):
            for dst in succs:
                out[dst].append((src, True))
        return out


def _catches_everything(handler: ast.AST) -> bool:
    """True for ``except:`` and ``except BaseException`` — the only
    clauses that also catch ``CancelledError`` (``except Exception``
    does not, since 3.8)."""
    if handler.type is None:
        return True
    names = []
    if isinstance(handler.type, ast.Tuple):
        names = [t for t in handler.type.elts]
    else:
        names = [handler.type]
    for t in names:
        tail = t.attr if isinstance(t, ast.Attribute) else \
            t.id if isinstance(t, ast.Name) else ""
        if tail == "BaseException":
            return True
    return False


class _Builder:
    """Single-pass recursive CFG construction.  ``cursor`` threading:
    each statement builder takes the list of dangling node indices
    whose fall-through reaches it, and returns the new dangling set."""

    def __init__(self) -> None:
        self.cfg = CFG()
        #: innermost-last exception targets (dispatch/finpad nodes);
        #: empty = propagate to the function's exceptional exit
        self.exc_stack: list[int] = []
        #: active finally pads a non-local exit must run through
        self.fin_stack: list[int] = []
        #: (header node, break-exit collector, fin_stack depth at entry)
        self.loop_stack: list[tuple[int, list[int], int]] = []

    # -- plumbing --

    def _exc_target(self) -> int:
        return self.exc_stack[-1] if self.exc_stack \
            else self.cfg.raise_exit

    def _wire(self, frm: Sequence[int], to: int) -> None:
        for f in frm:
            self.cfg.flow[f].add(to)

    def _new(self, stmt: Optional[ast.AST], cursor: Sequence[int],
             kind: str = K_STMT) -> int:
        n = self.cfg.add_node(kind, stmt)
        self._wire(cursor, n)
        if stmt is not None and may_raise(stmt):
            self.cfg.exc[n].add(self._exc_target())
        return n

    def _nonlocal_exit(self, n: int, target: int,
                       fin_floor: int = 0) -> None:
        """Wire a return/break/continue node: directly to its target
        AND through any finally pads entered above ``fin_floor`` (both
        edges — see the simplifications note)."""
        self.cfg.flow[n].add(target)
        if len(self.fin_stack) > fin_floor:
            self.cfg.flow[n].add(self.fin_stack[-1])

    # -- statement dispatch --

    def seq(self, stmts: Sequence[ast.AST],
            cursor: list[int]) -> list[int]:
        for stmt in stmts:
            cursor = self.build_stmt(stmt, cursor)
        return cursor

    def build_stmt(self, stmt: ast.AST,
                   cursor: list[int]) -> list[int]:
        if isinstance(stmt, ast.Return):
            n = self._new(stmt, cursor)
            self._nonlocal_exit(n, self.cfg.exit)
            return []
        if isinstance(stmt, ast.Raise):
            n = self.cfg.add_node(K_STMT, stmt)
            self._wire(cursor, n)
            self.cfg.exc[n].add(self._exc_target())
            return []
        if isinstance(stmt, ast.Break):
            n = self._new(stmt, cursor)
            if self.loop_stack:
                _header, breaks, fin_floor = self.loop_stack[-1]
                breaks.append(n)
                if len(self.fin_stack) > fin_floor:
                    self.cfg.flow[n].add(self.fin_stack[-1])
            return []
        if isinstance(stmt, ast.Continue):
            n = self._new(stmt, cursor)
            if self.loop_stack:
                header, _breaks, fin_floor = self.loop_stack[-1]
                self._nonlocal_exit(n, header, fin_floor)
            return []
        if isinstance(stmt, ast.If):
            return self._build_if(stmt, cursor)
        if isinstance(stmt, (ast.While,)):
            return self._build_while(stmt, cursor)
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            return self._build_for(stmt, cursor)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            n = self._new(stmt, cursor)
            return self.seq(stmt.body, [n])
        if isinstance(stmt, ast.Try):
            return self._build_try(stmt, cursor)
        if isinstance(stmt, ast.Match):
            return self._build_match(stmt, cursor)
        # simple statement (incl. nested def/class definitions, whose
        # bodies are separate graphs)
        return [self._new(stmt, cursor)]

    # -- control constructs --

    def _build_if(self, stmt: ast.If, cursor: list[int]) -> list[int]:
        test = self._new(stmt, cursor)
        exits = self.seq(stmt.body, [test])
        if stmt.orelse:
            exits += self.seq(stmt.orelse, [test])
        else:
            exits.append(test)
        return exits

    @staticmethod
    def _const_true(expr: ast.AST) -> bool:
        return isinstance(expr, ast.Constant) and bool(expr.value)

    def _build_while(self, stmt: ast.While,
                     cursor: list[int]) -> list[int]:
        header = self._new(stmt, cursor)
        breaks: list[int] = []
        self.loop_stack.append((header, breaks, len(self.fin_stack)))
        body_exits = self.seq(stmt.body, [header])
        self._wire(body_exits, header)  # back edges
        self.loop_stack.pop()
        if self._const_true(stmt.test):
            # `while True`: the only normal exits are breaks (orelse
            # is dead code then)
            return breaks
        exits = list(breaks)
        if stmt.orelse:
            exits += self.seq(stmt.orelse, [header])
        else:
            exits.append(header)
        return exits

    def _build_for(self, stmt: ast.AST,
                   cursor: list[int]) -> list[int]:
        # the header node is the iteration step: target rebinding and
        # __next__/__anext__ both happen here (async: suspension too)
        header = self._new(stmt, cursor)
        breaks: list[int] = []
        self.loop_stack.append((header, breaks, len(self.fin_stack)))
        body_exits = self.seq(stmt.body, [header])
        self._wire(body_exits, header)
        self.loop_stack.pop()
        exits = list(breaks)
        if stmt.orelse:
            exits += self.seq(stmt.orelse, [header])
        else:
            exits.append(header)
        return exits

    def _build_match(self, stmt: ast.Match,
                     cursor: list[int]) -> list[int]:
        subj = self._new(stmt, cursor)
        exits: list[int] = [subj]  # no case may match
        for case in stmt.cases:
            exits += self.seq(case.body, [subj])
        return exits

    def _build_try(self, stmt: ast.Try,
                   cursor: list[int]) -> list[int]:
        cfg = self.cfg
        outer = self._exc_target()
        fin_pad = cfg.add_node(K_FINPAD) if stmt.finalbody else None
        dispatch = cfg.add_node(K_DISPATCH) if stmt.handlers else None
        body_propagate = fin_pad if fin_pad is not None else outer

        if fin_pad is not None:
            self.fin_stack.append(fin_pad)

        # body: exceptions go to the handler dispatch (else straight to
        # the finally/outer frame)
        self.exc_stack.append(
            dispatch if dispatch is not None else body_propagate)
        body_exits = self.seq(stmt.body, list(cursor))
        self.exc_stack.pop()

        # orelse runs after a clean body and is NOT covered by the
        # handlers — its exceptions skip them (but do run finally)
        if stmt.orelse:
            self.exc_stack.append(body_propagate)
            body_exits = self.seq(stmt.orelse, body_exits)
            self.exc_stack.pop()

        handler_exits: list[int] = []
        if dispatch is not None:
            # an exception the handler list does not match propagates —
            # unless some handler is a catch-all (`except:` / `except
            # BaseException`; Exception does NOT qualify, it misses
            # CancelledError — the distinction this family exists for)
            if not any(_catches_everything(h) for h in stmt.handlers):
                cfg.exc[dispatch].add(body_propagate)
            for handler in stmt.handlers:
                h = cfg.add_node(K_HANDLER, handler)
                cfg.flow[dispatch].add(h)
                self.exc_stack.append(body_propagate)
                handler_exits += self.seq(handler.body, [h])
                self.exc_stack.pop()

        if fin_pad is not None:
            self.fin_stack.pop()
            self._wire(body_exits + handler_exits, fin_pad)
            self.exc_stack.append(outer)
            fin_exits = self.seq(stmt.finalbody, [fin_pad])
            self.exc_stack.pop()
            # the finally block may be completing an exceptional path:
            # its exits also propagate outward
            for e in fin_exits:
                cfg.exc[e].add(outer)
            return fin_exits
        return body_exits + handler_exits


def build_cfg(fn: ast.AST) -> CFG:
    """CFG for one ``def``/``async def`` body (lambdas have no
    statements — callers skip them)."""
    b = _Builder()
    exits = b.seq(fn.body, [b.cfg.entry])
    b._wire(exits, b.cfg.exit)
    return b.cfg


def dataflow(cfg: CFG, gen: Sequence[frozenset],
             kill: Sequence[frozenset], *, must: bool = False,
             init: frozenset = frozenset()) -> list[Optional[frozenset]]:
    """Forward gen/kill analysis to fixpoint; returns IN per node.

    *may* (default): union meet, unreachable nodes hold the empty set.
    *must*: intersection meet, unreachable nodes hold ``None`` (TOP).
    Edge transfer: flow edges carry ``(IN - kill) | gen``; exc edges
    carry ``IN - kill`` (pre-state with kills — see module docstring).
    ``init`` seeds the entry node (CB405 uses it for entered-metered
    frames)."""
    n = cfg.n_nodes
    preds = cfg.preds()
    inn: list[Optional[frozenset]] = \
        [None if must else frozenset()] * n
    inn[cfg.entry] = init
    changed = True
    while changed:
        changed = False
        for node in range(n):
            if node == cfg.entry:
                continue
            acc: Optional[frozenset] = None
            for pred, is_exc in preds[node]:
                pin = inn[pred]
                if pin is None:
                    continue  # TOP / not yet reached
                out = pin - kill[pred]
                if not is_exc:
                    out = out | gen[pred]
                if acc is None:
                    acc = out
                elif must:
                    acc = acc & out
                else:
                    acc = acc | out
            if acc is None:
                continue
            if acc != inn[node]:
                inn[node] = acc
                changed = True
    return inn
