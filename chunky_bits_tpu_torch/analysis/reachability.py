"""Shared per-run project context: one call graph, memoized reachability.

``core.run_analysis`` constructs ONE :class:`ProjectContext` per run and
hands it to every project-granular rule (CB204, the CB3xx family), so
the interprocedural pass parses and links the tree exactly once however
many rules consume it — the property that keeps a whole-tree run
inside its runtime budget.

Root *specs* name functions structurally rather than by line number so
the rules survive refactors: ``("file/slab.py", "SlabStore.append")``
matches the method wherever it moves inside the file, and a spec whose
qualname is ``"*"`` roots every function in the module (the sim-scenario
roots).  Specs that match nothing are reported by
:meth:`ProjectContext.resolve_roots` callers as rule errors rather than
silently shrinking the reachable set.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from .callgraph import CallGraph, FuncInfo, build_call_graph


class ProjectContext:
    """Lazily built call graph + cached reachability over one scan."""

    def __init__(self, sources: Sequence) -> None:
        self._sources = list(sources)
        self._graph: Optional[CallGraph] = None
        self._reach_cache: dict[frozenset, frozenset] = {}
        #: function key -> built CFG (the CB4xx rules share one graph
        #: per function however many rules query it)
        self._cfg_cache: dict = {}
        #: interprocedural summary tags recorded by dataflow rules —
        #: counted into ``--graph-stats``
        self._summaries: set = set()
        #: rel -> SourceFile, for rules that need suppression scans
        self.by_rel = {sf.rel: sf for sf in self._sources}

    @property
    def graph(self) -> CallGraph:
        if self._graph is None:
            self._graph = build_call_graph(self._sources)
        return self._graph

    def resolve_roots(self, specs: Iterable[tuple[str, str]]
                      ) -> set[tuple[str, str]]:
        """Graph keys for root specs.

        A spec is ``(rel, qualname_suffix)``: it matches functions in
        ``rel`` whose qualname equals the suffix OR ends with
        ``"." + suffix`` (so ``"write"`` matches every ``write`` method
        in the module without naming each class).  ``("sim/x.py", "*")``
        roots the whole module."""
        graph = self.graph
        keys: set[tuple[str, str]] = set()
        for rel, suffix in specs:
            for info in graph.functions.values():
                if info.rel != rel:
                    continue
                if suffix == "*" or info.qualname == suffix \
                        or info.qualname.endswith("." + suffix):
                    keys.add(info.key)
        return keys

    def reachable_from(self, roots: Iterable[tuple[str, str]]
                       ) -> frozenset:
        """Memoized transitive closure over the call graph."""
        key = frozenset(roots)
        cached = self._reach_cache.get(key)
        if cached is None:
            cached = frozenset(self.graph.reachable(key))
            self._reach_cache[key] = cached
        return cached

    def cfg_of(self, info: FuncInfo):
        """Memoized statement-granular CFG for one function (built by
        ``analysis.cfg.build_cfg``; shared across every CB4xx rule)."""
        cfg = self._cfg_cache.get(info.key)
        if cfg is None:
            from .cfg import build_cfg
            cfg = build_cfg(info.node)
            self._cfg_cache[info.key] = cfg
        return cfg

    def note_summary(self, tag) -> None:
        """Record one composed per-function dataflow summary (an opaque
        hashable tag) for the ``--graph-stats`` report."""
        self._summaries.add(tag)

    def cfg_stats(self) -> dict[str, int]:
        """CFG-layer totals for ``--graph-stats`` (zeroes until a CB4xx
        rule has run and populated the caches)."""
        cfgs = self._cfg_cache.values()
        return {
            "cfg_functions": len(self._cfg_cache),
            "cfg_blocks": sum(c.n_nodes for c in cfgs),
            "cfg_edges": sum(c.n_edges for c in cfgs),
            "dataflow_summaries": len(self._summaries),
        }

    def reachable_infos(self, roots: Iterable[tuple[str, str]]
                        ) -> list[FuncInfo]:
        """FuncInfos for the closure, in deterministic (rel, line)
        order so findings sort stably across runs."""
        graph = self.graph
        infos = [graph.functions[k]
                 for k in self.reachable_from(roots)
                 if k in graph.functions]
        infos.sort(key=lambda i: (i.rel, i.lineno, i.qualname))
        return infos
