"""simlint driver: parse, run rules, apply inline suppressions.

Suppression syntax (documented in docs/determinism.md):

    x = hash(name) % 4          # simlint: ok(builtin-hash): <justification>
    # simlint: ok(held-lock-timeout): modeled hold window, released below
    yield env.timeout(hold)

A trailing comment covers its own line; a comment alone on a line covers
the next line. Several rules may be listed: ``ok(rule-a, rule-b)``. Every
suppression must actually suppress something — one that matches no finding
is itself reported as ``stale-suppression``, so stale annotations cannot
accumulate as the code under them changes.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
from dataclasses import dataclass
from typing import Iterable, List, Set

from . import rules as _rules

DEFAULT_PATHS = ("src/repro_torch/core", "src/repro_torch/simcore")

_SUPPRESS_RE = re.compile(r"#\s*simlint:\s*ok\(([^)]*)\)(?::\s*(\S.*))?")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class _Suppression:
    line: int               # line the comment sits on
    covers: Set[int]        # lines it applies to
    rules: Set[str]
    used: bool = False


def _collect_suppressions(source: str, path: str) -> List[_Suppression]:
    out: List[_Suppression] = []
    for i, text in enumerate(source.splitlines(), start=1):
        m = _SUPPRESS_RE.search(text)
        if m is None:
            continue
        names = {r.strip() for r in m.group(1).split(",") if r.strip()}
        covers = {i + 1} if text.lstrip().startswith("#") else {i}
        out.append(_Suppression(line=i, covers=covers, rules=names))
    return out


def lint_source(source: str, path: str = "<string>") -> List[Finding]:
    import ast
    tree = ast.parse(source, filename=path)
    raw = _rules.all_raw_findings(tree, source)
    supps = _collect_suppressions(source, path)
    findings: List[Finding] = []
    for line, rule, message in raw:
        sup = next((s for s in supps
                    if line in s.covers and rule in s.rules), None)
        if sup is not None:
            sup.used = True
            continue
        findings.append(Finding(path, line, rule, message))
    for sup in supps:
        unknown = sup.rules - set(_rules.RULE_NAMES)
        if unknown:
            findings.append(Finding(
                path, sup.line, "stale-suppression",
                f"unknown rule name(s) {sorted(unknown)} in suppression"))
        elif not sup.used:
            findings.append(Finding(
                path, sup.line, "stale-suppression",
                f"suppression ok({', '.join(sorted(sup.rules))}) matches no "
                f"finding — the code it excused has changed; delete it"))
    findings.sort(key=lambda f: (f.line, f.rule))
    return findings


def lint_file(path: str) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), path)


def _py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, names in os.walk(p):
                out.extend(os.path.join(root, n)
                           for n in names if n.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
        else:
            print(f"warning: skipping non-python argument {p!r}",
                  file=sys.stderr)
    return sorted(out)


def lint_paths(paths: Iterable[str]) -> List[Finding]:
    findings: List[Finding] = []
    for f in _py_files(paths):
        findings.extend(lint_file(f))
    return findings


def main(argv: List[str] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="simlint",
        description="determinism lint for the DES control plane "
                    "(rule catalog: docs/determinism.md)")
    parser.add_argument("paths", nargs="*", default=list(DEFAULT_PATHS),
                        help="files or directories to lint "
                             f"(default: {' '.join(DEFAULT_PATHS)})")
    parser.add_argument("--list-rules", action="store_true",
                        help="print rule names and exit")
    args = parser.parse_args(argv)
    if args.list_rules:
        for name in _rules.RULE_NAMES:
            print(name)
        return 0
    findings = lint_paths(args.paths)
    for f in findings:
        print(f)
    n_files = len(_py_files(args.paths))
    print(f"simlint: checked {n_files} files, {len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
