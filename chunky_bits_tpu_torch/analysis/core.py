"""Analyzer plumbing: file model, suppressions, baseline, runner.

Everything here is stdlib-only (``ast`` + ``tokenize`` + ``hashlib``).
The TOML baseline is read with ``tomllib`` (3.11+) or ``tomli`` when
present, with a minimal fallback parser for the restricted subset this
module itself emits — the gate must run on a bare interpreter.
"""

from __future__ import annotations

import ast
import hashlib
import io
import re
import tokenize
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Iterator, Optional

#: inline suppression: ``# lint: <slug>-ok <reason>`` — the reason is
#: mandatory (a bare marker does not suppress).  On a comment-only line
#: the marker covers the next line; trailing markers cover their own.
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*([a-z0-9-]+)-ok\b[ \t]*(.*)")

#: ``# noqa: BLE001 <text>`` is accepted as a broad-except justification
#: (one pre-existing site already uses the flake8-bugbear spelling).
_NOQA_BLE_RE = re.compile(r"#\s*noqa:\s*BLE001\b[ \t]*[-—:]?[ \t]*(.*)")


@dataclass(frozen=True)
class Violation:
    """One finding.  ``fingerprint`` identifies it across unrelated
    edits: it hashes the rule, the file, the enclosing def/class
    qualname, the stripped source line text, and the occurrence index
    of that text *within that scope* — never the line number — so a
    baseline survives both code motion AND duplicate-line churn (an
    identical line added in a DIFFERENT function no longer shifts this
    one's occurrence index).  ``legacy_fingerprint`` is the pre-scope
    spelling (no qualname, file-wide occurrence): baselines written
    before the scheme change still match through it, giving existing
    ``baseline.toml`` files a one-shot migration path — regenerate
    with ``--write-baseline`` to move onto scoped fingerprints."""

    rule: str
    slug: str
    path: str  # repo-relative posix path
    line: int
    col: int
    message: str
    snippet: str
    fingerprint: str
    scope: str = ""  # enclosing def/class qualname ('' = module level)
    legacy_fingerprint: str = ""

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.fingerprint)

    def keys(self) -> tuple[tuple[str, str, str], ...]:
        """Every baseline key this finding matches: the scoped
        fingerprint plus the legacy spelling (migration path)."""
        if not self.legacy_fingerprint:
            return (self.key(),)
        return (self.key(),
                (self.rule, self.path, self.legacy_fingerprint))

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.slug}] {self.message}")


class SourceFile:
    """One parsed module plus the comment-derived side tables rules
    need: inline suppressions and module-level string constants (env
    var names travel as constants, e.g. ``DISPATCH_TIMEOUT_ENV``)."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=rel)
        #: line -> {slug: reason}; a marker on a comment-only line is
        #: registered for that line AND the next
        self.suppressions: dict[int, dict[str, str]] = {}
        self._scan_comments()
        self.constants: dict[str, str] = {}
        for node in self.tree.body:
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and isinstance(node.value, ast.Constant)
                    and isinstance(node.value.value, str)):
                self.constants[node.targets[0].id] = node.value.value
        #: (start, end, qualname) line intervals of every def/class,
        #: for scope-qualified fingerprints; built once, sorted by
        #: (start, -end) so a linear scan finds the innermost match
        self._scopes = self._scope_intervals(self.tree)

    @staticmethod
    def _scope_intervals(tree: ast.AST) -> list[tuple[int, int, str]]:
        out: list[tuple[int, int, str]] = []

        def visit(node: ast.AST, quals: tuple[str, ...]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    q = quals + (child.name,)
                    out.append((child.lineno,
                                child.end_lineno or child.lineno,
                                ".".join(q)))
                    visit(child, q)
                else:
                    visit(child, quals)

        visit(tree, ())
        out.sort(key=lambda iv: (iv[0], -iv[1]))
        return out

    def scope_qualname(self, line: int) -> str:
        """Qualname of the innermost def/class containing ``line``
        ('' for module level).  Decorator lines belong to the scope
        ABOVE the decorated def — same as how the finding reads."""
        best = ""
        for start, end, qualname in self._scopes:
            if start > line:
                break
            if line <= end:
                best = qualname  # later intervals start deeper
        return best

    def _scan_comments(self) -> None:
        try:
            tokens = tokenize.generate_tokens(
                io.StringIO(self.text).readline)
            comments = [(t.start[0], t.start[1], t.string)
                        for t in tokens if t.type == tokenize.COMMENT]
        except (tokenize.TokenError, IndentationError, SyntaxError):
            comments = []
        for line, col, comment in comments:
            entries: dict[str, str] = {}
            m = _SUPPRESS_RE.search(comment)
            if m and m.group(2).strip():
                entries[m.group(1)] = m.group(2).strip()
            m = _NOQA_BLE_RE.search(comment)
            if m and m.group(1).strip():
                entries["broad-except"] = m.group(1).strip()
            if not entries:
                continue
            own_line = self.lines[line - 1] if line <= len(self.lines) \
                else ""
            targets = [line]
            if own_line.strip().startswith("#"):
                # comment-only line: the marker covers the next CODE
                # line, skipping continuation comment/blank lines so a
                # justification may wrap
                nxt = line + 1
                while nxt <= len(self.lines):
                    stripped = self.lines[nxt - 1].strip()
                    if stripped and not stripped.startswith("#"):
                        break
                    nxt += 1
                targets.append(nxt)
            for ln in targets:
                self.suppressions.setdefault(ln, {}).update(entries)

    def suppressed(self, slug: str, line: int) -> bool:
        return slug in self.suppressions.get(line, {})

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""


def _fingerprint(rule: str, rel: str, snippet: str, occurrence: int,
                 scope: Optional[str] = None) -> str:
    """Scoped fingerprint when ``scope`` is given (the current scheme);
    the legacy no-scope spelling otherwise (kept so pre-migration
    baselines still match — see Violation.keys)."""
    if scope is None:
        basis = f"{rule}\x00{rel}\x00{snippet}\x00{occurrence}"
    else:
        basis = (f"{rule}\x00{rel}\x00{scope}\x00{snippet}"
                 f"\x00{occurrence}")
    return hashlib.sha256(basis.encode("utf-8")).hexdigest()[:16]


def iter_python_files(root: Path) -> Iterator[Path]:
    for path in sorted(root.rglob("*.py")):
        if "__pycache__" in path.parts:
            continue
        yield path


def run_analysis(root: Path, rules: Iterable[object],
                 files: Optional[Iterable[Path]] = None,
                 stats: Optional[dict] = None
                 ) -> tuple[list[Violation], list[str]]:
    """Run ``rules`` over every ``*.py`` under ``root`` (or the explicit
    ``files``).  Returns ``(violations, errors)`` — a file that fails to
    parse is an *error*, not a silent skip: the gate must not go green
    because the tree stopped being parseable.

    Two rule shapes: per-file rules implement ``check(sf)``; *project*
    rules (``rule.project`` truthy: CB204, the CB3xx family) implement
    ``check_project(sfs, ctx)`` over every parsed file at once, sharing
    ONE :class:`~chunky_bits_tpu_torch.analysis.reachability.ProjectContext`
    (call graph + memoized reachability) so the interprocedural pass
    parses and links the tree exactly once per run.  Both shapes feed
    the same suppression, fingerprint, and baseline machinery.

    Pass a dict as ``stats`` to receive call-graph statistics
    (functions/edges/worker_roots/unknown_edges) — forces the graph to
    build even when no project rule is selected (the CLI's
    ``--graph-stats``)."""
    root = root.resolve()
    violations: list[Violation] = []
    errors: list[str] = []
    paths = list(files) if files is not None else \
        list(iter_python_files(root))
    sources: list[SourceFile] = []
    for path in paths:
        path = path.resolve()
        try:
            rel = path.relative_to(root).as_posix()
        except ValueError:
            # outside the root the rel path (which rule scopes and
            # baseline entries key off) cannot resolve; scanning under
            # a basename would silently skip every path-scoped rule
            # and report a false "ok"
            errors.append(f"{path}: outside --root {root}; pass a "
                          f"--root containing it")
            continue
        try:
            text = path.read_text(encoding="utf-8")
            sources.append(SourceFile(path, rel, text))
        except (OSError, SyntaxError, ValueError) as err:
            errors.append(f"{rel}: unreadable/unparseable: {err}")
            continue
    by_rel = {sf.rel: sf for sf in sources}
    # raw findings bucketed per file so fingerprint occurrence indices
    # stay per-file regardless of which rule shape produced them
    raw_by_rel: dict[str, list[tuple[object, int, int, str]]] = \
        {sf.rel: [] for sf in sources}
    per_file = [r for r in rules if not getattr(r, "project", False)]
    project = [r for r in rules if getattr(r, "project", False)]
    for sf in sources:
        for rule in per_file:
            if not rule.applies(sf.rel):
                continue
            for line, col, message in rule.check(sf):
                if sf.suppressed(rule.slug, line):
                    continue
                raw_by_rel[sf.rel].append((rule, line, col, message))
    ctx = None
    if project or stats is not None:
        # one shared context: every project rule reuses the same graph
        from chunky_bits_tpu_torch.analysis.reachability import ProjectContext
        ctx = ProjectContext(sources)
    for rule in project:
        for rel, line, col, message in rule.check_project(sources, ctx):
            sf = by_rel.get(rel)
            if sf is None or not rule.applies(rel) \
                    or sf.suppressed(rule.slug, line):
                continue
            raw_by_rel[rel].append((rule, line, col, message))
    if stats is not None and ctx is not None:
        stats.update(ctx.graph.stats())
        stats.update(ctx.cfg_stats())
    for sf in sources:
        raw = raw_by_rel[sf.rel]
        # occurrence index among same (rule, scope, snippet) triples in
        # line order keeps fingerprints stable under unrelated edits
        # AND under duplicate-line churn in other scopes; the legacy
        # (rule, snippet) counter feeds pre-migration baseline keys
        raw.sort(key=lambda item: (item[1], item[2]))
        seen: dict[tuple[str, str, str], int] = {}
        seen_legacy: dict[tuple[str, str], int] = {}
        for rule, line, col, message in raw:
            snippet = sf.line_text(line)
            scope = sf.scope_qualname(line)
            occ = seen.get((rule.id, scope, snippet), 0)
            seen[(rule.id, scope, snippet)] = occ + 1
            locc = seen_legacy.get((rule.id, snippet), 0)
            seen_legacy[(rule.id, snippet)] = locc + 1
            violations.append(Violation(
                rule=rule.id, slug=rule.slug, path=sf.rel, line=line,
                col=col, message=message, snippet=snippet,
                fingerprint=_fingerprint(rule.id, sf.rel, snippet, occ,
                                         scope=scope),
                scope=scope,
                legacy_fingerprint=_fingerprint(rule.id, sf.rel,
                                                snippet, locc)))
    return violations, errors


# ---- baseline file (analysis/baseline.toml) ----

def write_baseline(path: Path, violations: Iterable[Violation]) -> None:
    out = [
        "# Accepted pre-existing findings — the analyzer fails only on",
        "# NEW violations.  Regenerate with:",
        "#   python -m chunky_bits_tpu_torch.analysis --write-baseline",
        "# Entries are (rule, path, fingerprint); line/scope/summary",
        "# are informational (as of writing) and ignored on load.",
        "# Fingerprints are scope-qualified (rule, path, enclosing",
        "# qualname, line text, in-scope occurrence); entries written",
        "# by older versions still match through the legacy no-scope",
        "# spelling until regenerated.",
        "",
    ]
    for v in sorted(violations, key=lambda v: (v.path, v.line, v.rule)):
        out.append("[[violation]]")
        out.append(f'rule = "{v.rule}"')
        out.append(f'path = "{v.path}"')
        out.append(f'fingerprint = "{v.fingerprint}"')
        out.append(f"line = {v.line}")
        if v.scope:
            out.append(f'scope = "{_toml_escape(v.scope)}"')
        out.append(f'summary = "{_toml_escape(v.message)}"')
        out.append("")
    path.write_text("\n".join(out), encoding="utf-8")


def _toml_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def load_baseline(path: Path) -> set[tuple[str, str, str]]:
    """Accepted-violation keys from the baseline file; an absent file is
    an empty baseline.  A file that exists but does not parse raises
    ``ValueError`` with a clean diagnostic — a hand-edit typo must fail
    the gate loudly, not as a raw decoder traceback (and never silently
    shrink the accepted set)."""
    if not path.exists():
        return set()
    text = path.read_text(encoding="utf-8")
    try:
        data = _parse_toml(text)
    except Exception as err:
        raise ValueError(f"baseline {path}: unparseable TOML: {err}") \
            from err
    keys = set()
    for entry in data.get("violation", []):
        try:
            keys.add((str(entry["rule"]), str(entry["path"]),
                      str(entry["fingerprint"])))
        except KeyError:
            continue
    return keys


def _parse_toml(text: str) -> dict:
    try:
        import tomllib  # Python 3.11+
        return tomllib.loads(text)
    except ImportError:
        pass
    try:
        import tomli
        return tomli.loads(text)
    except ImportError:
        pass
    return _parse_minimal_toml(text)


def _parse_minimal_toml(text: str) -> dict:
    """Fallback parser for exactly the subset ``write_baseline`` emits:
    ``[[violation]]`` tables of ``key = "string"`` / ``key = int``
    lines.  Not a general TOML parser and not meant to be."""
    data: dict = {}
    current: Optional[dict] = None
    for rawline in text.splitlines():
        line = rawline.strip()
        if not line or line.startswith("#"):
            continue
        m = re.fullmatch(r"\[\[([A-Za-z0-9_-]+)\]\]", line)
        if m:
            current = {}
            data.setdefault(m.group(1), []).append(current)
            continue
        m = re.fullmatch(r'([A-Za-z0-9_-]+)\s*=\s*"(.*)"', line)
        if m and current is not None:
            current[m.group(1)] = (m.group(2)
                                   .replace('\\"', '"')
                                   .replace("\\\\", "\\"))
            continue
        m = re.fullmatch(r"([A-Za-z0-9_-]+)\s*=\s*(-?\d+)", line)
        if m and current is not None:
            current[m.group(1)] = int(m.group(2))
    return data
