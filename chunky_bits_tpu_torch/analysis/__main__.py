"""CLI: ``python -m chunky_bits_tpu_torch.analysis``.

Exit codes: 0 clean (no violations beyond the baseline), 1 new
violations (or unparseable files — the gate must not go green because
the tree stopped parsing), 2 usage errors.  ``--json`` emits one
machine-readable object.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from chunky_bits_tpu_torch.analysis.core import (
    iter_python_files,
    load_baseline,
    run_analysis,
    write_baseline,
)
from chunky_bits_tpu_torch.analysis.rules import ALL_RULES, rule_family

PACKAGE_ROOT = Path(__file__).resolve().parents[1]
DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.toml"


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m chunky_bits_tpu_torch.analysis",
        description="project-native invariant linter (see analysis/"
                    "__init__.py for the invariant -> rule map)")
    parser.add_argument(
        "paths", nargs="*", type=Path,
        help="files/dirs to scan (default: the chunky_bits_tpu_torch "
             "package)")
    parser.add_argument(
        "--root", type=Path, default=PACKAGE_ROOT,
        help="root that rel paths (rule scopes, baseline entries) are "
             "resolved against (default: the package dir)")
    parser.add_argument(
        "--baseline", type=Path, default=DEFAULT_BASELINE,
        help="baseline file of accepted findings "
             "(default: analysis/baseline.toml)")
    parser.add_argument(
        "--no-baseline", action="store_true",
        help="ignore the baseline: report every finding")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="accept all current findings into the baseline and exit 0")
    parser.add_argument(
        "--prune-baseline", action="store_true",
        help="rewrite the baseline keeping only entries that still "
             "match a finding (drops stale accepts; migrates legacy "
             "fingerprints to scoped ones); never adds entries")
    parser.add_argument(
        "--select", default="",
        help="comma-separated rule ids or family prefixes to run "
             "(e.g. CB101,CB104 — or CB2 for the whole CB2xx family)")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON object instead of text")
    parser.add_argument(
        "--format", choices=("text", "github"), default="text",
        help="text (default) or github workflow-annotation lines "
             "(::error file=...) for new violations/errors")
    parser.add_argument(
        "--graph-stats", action="store_true",
        help="also report call-graph statistics (functions/edges/"
             "worker roots/unknown-edge count) and CFG totals "
             "(functions/blocks/edges/dataflow summaries) so graph "
             "precision regressions show up in the lint report")
    parser.add_argument(
        "--explain", metavar="RULE",
        help="print the full rationale + fix pattern for a rule id, "
             "family prefix (CB3), or slug, then exit")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.explain:
        want = args.explain.strip()
        matched = [r for r in ALL_RULES
                   if r.id.upper().startswith(want.upper())
                   or r.slug == want.lower()]
        if not matched:
            parser.error(f"--explain: no rule matches {want!r}")
        for i, rule in enumerate(matched):
            if i:
                print()
            doc = (rule.__doc__ or "(no rationale recorded)").strip()
            print(f"{rule.id} [{rule.slug}] — {rule.description}")
            if rule.paths:
                print(f"scope: {', '.join(rule.paths)}")
            print()
            print(doc)
        return 0

    rules = ALL_RULES
    if args.select:
        # empty tokens (trailing/doubled commas) would prefix-match
        # every rule and silently widen the scan — drop them, and
        # error when nothing real remains
        wanted = {r.strip().upper() for r in args.select.split(",")
                  if r.strip()}
        if not wanted:
            parser.error("--select given but no rule ids in it")
        # a token selects every rule id it prefixes, so CB2 selects the
        # whole CB2xx family and CB101 selects exactly itself
        unknown = {w for w in wanted
                   if not any(r.id.startswith(w) for r in ALL_RULES)}
        if unknown:
            parser.error(
                f"unknown rule ids: {', '.join(sorted(unknown))}")
        rules = tuple(r for r in ALL_RULES
                      if any(r.id.startswith(w) for w in wanted))

    if args.list_rules:
        from chunky_bits_tpu_torch.analysis.rules import FAMILY_HAZARDS

        families: dict[str, list] = {}
        for rule in rules:
            families.setdefault(rule.family, []).append(rule)
        for family in sorted(families):
            hazard = FAMILY_HAZARDS.get(family, "")
            print(f"{family} — {hazard}" if hazard else family)
            for rule in families[family]:
                print(f"  {rule.id}  {rule.slug:18s} {rule.description}")
        return 0

    files = None
    if args.paths:
        files = []
        for p in args.paths:
            if p.is_dir():
                files.extend(iter_python_files(p))
            elif p.exists():
                files.append(p)
            else:
                parser.error(f"no such path: {p}")

    stats: dict | None = {} if args.graph_stats else None
    violations, errors = run_analysis(args.root, rules, files=files,
                                      stats=stats)

    if args.write_baseline:
        if args.select or files is not None:
            # a restricted scan sees only a subset of findings; writing
            # it out would silently drop every accepted entry outside
            # the subset and fail the next full gate run for everyone
            parser.error("--write-baseline requires a full scan "
                         "(drop --select and explicit paths)")
        if errors:
            # same hazard as above: an unparseable file's accepted
            # findings are absent from this scan, so writing now would
            # drop them and re-fail the gate once the file is fixed
            for err in errors:
                print(f"ERROR {err}", file=sys.stderr)
            parser.error("--write-baseline refused: the scan had file "
                         "errors (fix them first)")
        write_baseline(args.baseline, violations)
        print(f"wrote {len(violations)} accepted finding(s) to "
              f"{args.baseline}")
        return 0

    if args.prune_baseline:
        # same refusal logic as --write-baseline: a restricted or
        # error-laden scan cannot distinguish "stale" from "not
        # scanned", and pruning on it would drop live accepts
        if args.select or files is not None:
            parser.error("--prune-baseline requires a full scan "
                         "(drop --select and explicit paths)")
        if errors:
            for err in errors:
                print(f"ERROR {err}", file=sys.stderr)
            parser.error("--prune-baseline refused: the scan had file "
                         "errors (fix them first)")
        try:
            baseline = load_baseline(args.baseline)
        except ValueError as err:
            parser.error(str(err))
        kept = [v for v in violations if set(v.keys()) & baseline]
        matched = baseline & {k for v in kept for k in v.keys()}
        dropped = len(baseline) - len(matched)
        write_baseline(args.baseline, kept)
        print(f"kept {len(kept)} accepted finding(s), dropped "
              f"{dropped} stale entr(y/ies) in {args.baseline}")
        return 0

    try:
        baseline = set() if args.no_baseline \
            else load_baseline(args.baseline)
    except ValueError as err:
        parser.error(str(err))
    # a finding matches through its scoped fingerprint OR the legacy
    # no-scope spelling (pre-migration baselines keep working)
    new = [v for v in violations
           if not (set(v.keys()) & baseline)]
    matched_entries = baseline & {k for v in violations
                                  for k in v.keys()}
    baselined = len(violations) - len(new)
    stale = len(baseline) - len(matched_entries)

    if args.json:
        out = {
            "new": [{**v.__dict__, "rule_family": rule_family(v.rule)}
                    for v in new],
            "baselined": baselined,
            "stale_baseline_entries": stale,
            "errors": errors,
            "ok": not new and not errors,
        }
        if stats is not None:
            out["graph"] = stats
        print(json.dumps(out))
        return 1 if (new or errors) else 0

    if args.format == "github":
        # workflow-annotation lines; paths are emitted relative to the
        # process cwd (the repo checkout in CI) so the annotations
        # attach to the right files in the diff view
        try:
            prefix = args.root.resolve().relative_to(
                Path.cwd().resolve()).as_posix()
        except ValueError:
            prefix = ""
        for err in errors:
            print("::error title=chunky-bits-tpu-torch analysis::"
                  f"{_annotation_escape(err)}")
        for v in new:
            loc = f"{prefix}/{v.path}" if prefix else v.path
            print(f"::error file={loc},line={v.line},col={v.col},"
                  f"title={v.rule} [{v.slug}]::"
                  f"{_annotation_escape(v.message)}")
    else:
        for err in errors:
            print(f"ERROR {err}")
        for v in new:
            print(v.render())
            print(f"    {v.snippet}")
    summary = (f"{len(new)} new violation(s), {baselined} baselined, "
               f"{stale} stale baseline entr(y/ies), "
               f"{len(errors)} file error(s)")
    if stats is not None:
        summary += (f"; graph: {stats.get('functions', 0)} functions, "
                    f"{stats.get('edges', 0)} edges, "
                    f"{stats.get('worker_roots', 0)} worker roots, "
                    f"{stats.get('unknown_edges', 0)} unknown edges"
                    f"; cfg: {stats.get('cfg_functions', 0)} functions, "
                    f"{stats.get('cfg_blocks', 0)} blocks, "
                    f"{stats.get('cfg_edges', 0)} edges, "
                    f"{stats.get('dataflow_summaries', 0)} summaries")
    if new or errors:
        print(f"FAIL: {summary}")
        return 1
    print(f"ok: {summary}")
    return 0


def _annotation_escape(text: str) -> str:
    """GitHub workflow-command data escaping (%, CR, LF)."""
    return (text.replace("%", "%25")
                .replace("\r", "%0D")
                .replace("\n", "%0A"))


if __name__ == "__main__":
    sys.exit(main())
