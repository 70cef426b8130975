"""obcheck shared infrastructure for the port: findings, pragmas,
baseline diffing.

A ``Finding``'s identity (``key``) deliberately omits the line number:
baselined findings must survive unrelated edits above them, so identity
is (rule, file, function, message) and the diff is a multiset subtract —
adding a SECOND ``int()`` sync to a function that already had one is a
new finding even though the key repeats.
"""

from __future__ import annotations

import ast
import json
import os
import re
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

# rule families (each checker documents its rules under one family)
FAMILIES = ("trace", "mask", "lock", "metric", "time", "io", "cancel",
            "rpc")

_PRAGMA_RE = re.compile(r"#\s*obcheck:\s*ok\(([^)]*)\)")


@dataclass(frozen=True)
class Finding:
    """One static-analysis violation."""

    rule: str      # dotted rule id, e.g. "trace.host-sync"
    path: str      # repo-relative file path
    line: int      # 1-based line of the offending node
    func: str      # enclosing function qualname ("" for module level)
    message: str   # human-readable description

    @property
    def key(self) -> str:
        """Baseline identity — line-free so edits above don't churn."""
        return f"{self.rule}|{self.path}|{self.func}|{self.message}"

    def render(self) -> str:
        where = f"{self.path}:{self.line}"
        fn = f" [{self.func}]" if self.func else ""
        return f"{where}: {self.rule}{fn}: {self.message}"


class Analyzer:
    """Parsed view of a set of source files.

    ``files`` maps repo-relative paths to source text; tests feed
    synthetic trees, the CLI feeds the real package.  Files that fail to
    parse produce a ``<family>.parse-error`` finding instead of crashing
    the run (a syntax error must fail CI loudly, not silently skip the
    file's checks).
    """

    def __init__(self, files: dict[str, str]):
        self.files = dict(files)
        self.trees: dict[str, ast.Module] = {}
        self.lines: dict[str, list[str]] = {}
        self.parse_errors: list[Finding] = []
        for path, src in self.files.items():
            self.lines[path] = src.splitlines()
            try:
                self.trees[path] = ast.parse(src)
            except SyntaxError as e:
                self.parse_errors.append(Finding(
                    rule="trace.parse-error", path=path,
                    line=e.lineno or 0, func="",
                    message=f"unparseable source: {e.msg}"))

    # -- pragmas ---------------------------------------------------------
    def pragma_rules(self, path: str, line: int) -> set[str]:
        """Pragma entries covering 1-based ``line`` (same line or the
        line directly above)."""
        out: set[str] = set()
        lines = self.lines.get(path, [])
        for ln in (line, line - 1):
            if 1 <= ln <= len(lines):
                m = _PRAGMA_RE.search(lines[ln - 1])
                if m:
                    out |= {p.strip() for p in m.group(1).split(",")
                            if p.strip()}
        return out

    def suppressed(self, path: str, line: int, rule: str) -> bool:
        """A pragma suppresses a rule by exact id or by family prefix
        (``ok(trace)`` covers every ``trace.*`` rule)."""
        for p in self.pragma_rules(path, line):
            if p == rule or rule.startswith(p + "."):
                return True
        return False

    def filter(self, findings: Iterable[Finding]) -> list[Finding]:
        """Drop pragma-suppressed findings."""
        return [f for f in findings
                if not self.suppressed(f.path, f.line, f.rule)]


# ---------------------------------------------------------------------------
# AST helpers shared by the checkers
# ---------------------------------------------------------------------------


def iter_functions(tree: ast.Module):
    """Yield (qualname, func_node, class_name|None) for every def in the
    module, including methods and nested functions.  Qualnames follow
    ``Class.method`` / ``outer.<locals>.inner`` convention."""

    def walk(node, prefix, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child, cls
                yield from walk(child, q + ".<locals>.", cls)
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, child.name + ".", child.name)
            else:
                yield from walk(child, prefix, cls)

    yield from walk(tree, "", None)


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` attribute/name chain as a string, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def names_in(node: ast.AST) -> set[str]:
    """All bare Name identifiers referenced anywhere under ``node``."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def attrs_in(node: ast.AST) -> set[str]:
    """All attribute names accessed anywhere under ``node``."""
    return {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


# ---------------------------------------------------------------------------
# file discovery
# ---------------------------------------------------------------------------


def load_package_files(root: str) -> dict[str, str]:
    """Repo-relative path -> source for every .py under the port's
    package and the port's own scripts (``scripts/torch_*.py``); the JAX
    package and its scripts are the reference's to check."""
    files: dict[str, str] = {}

    def add(full):
        rel = os.path.relpath(full, root).replace(os.sep, "/")
        with open(full, encoding="utf-8") as fh:
            files[rel] = fh.read()

    base = os.path.join(root, "oceanbase_tpu_torch")
    if os.path.isdir(base):
        for dirpath, _dirs, names in os.walk(base):
            for n in sorted(names):
                if n.endswith(".py"):
                    add(os.path.join(dirpath, n))
    scripts = os.path.join(root, "scripts")
    if os.path.isdir(scripts):
        for n in sorted(os.listdir(scripts)):
            if n.startswith("torch_") and n.endswith(".py"):
                add(os.path.join(scripts, n))
    return files


# ---------------------------------------------------------------------------
# run + baseline
# ---------------------------------------------------------------------------

BASELINE_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "baseline.json")


def default_checkers() -> tuple:
    from oceanbase_tpu_torch.analysis.cancel_rules import check_cancel_rules
    from oceanbase_tpu_torch.analysis.io_rules import check_io_rules
    from oceanbase_tpu_torch.analysis.lock_order import check_lock_order
    from oceanbase_tpu_torch.analysis.mask_discipline import (
        check_mask_discipline,
    )
    from oceanbase_tpu_torch.analysis.metric_rules import check_metric_rules
    from oceanbase_tpu_torch.analysis.rpc_rules import check_rpc_rules
    from oceanbase_tpu_torch.analysis.time_rules import check_time_rules
    from oceanbase_tpu_torch.analysis.trace_safety import check_trace_safety

    return (check_trace_safety, check_mask_discipline, check_lock_order,
            check_metric_rules, check_time_rules, check_io_rules,
            check_cancel_rules, check_rpc_rules)


def _order(f: Finding):
    return (f.path, f.line, f.rule, f.message)


def run_all_marked(files: dict[str, str],
                   checkers: Sequence[Callable[[Analyzer], list[Finding]]]
                   | None = None,
                   timings: dict[str, float] | None = None
                   ) -> list[tuple[Finding, bool]]:
    """Every checker over ``files``, BEFORE pragmas apply: each finding
    paired with whether a pragma suppresses it.  Deterministic order
    (path, line, rule).  When ``timings`` is a dict, per-checker wall
    time accumulates into it keyed by the checker's ``__name__``."""
    if checkers is None:
        checkers = default_checkers()
    az = Analyzer(files)
    findings: list[Finding] = list(az.parse_errors)
    for chk in checkers:
        t0 = time.monotonic()
        findings.extend(chk(az))
        if timings is not None:
            timings[chk.__name__] = (timings.get(chk.__name__, 0.0)
                                     + time.monotonic() - t0)
    return [(f, az.suppressed(f.path, f.line, f.rule))
            for f in sorted(findings, key=_order)]


def run_all(files: dict[str, str],
            checkers: Sequence[Callable[[Analyzer], list[Finding]]]
            | None = None,
            timings: dict[str, float] | None = None) -> list[Finding]:
    """Run every checker over ``files``; pragma-suppressed findings are
    already dropped (``run_all_marked`` keeps them)."""
    return [f for f, sup in run_all_marked(files, checkers, timings)
            if not sup]


def load_baseline(path: str = BASELINE_PATH) -> Counter:
    """Baseline as a multiset of finding keys (empty when absent)."""
    if not os.path.exists(path):
        return Counter()
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    return Counter({k: int(v) for k, v in data.get("counts", {}).items()})


def write_baseline(findings: Sequence[Finding],
                   path: str = BASELINE_PATH) -> dict:
    counts = Counter(f.key for f in findings)
    data = {
        "version": 1,
        "total": sum(counts.values()),
        # sorted for stable diffs of the checked-in file
        "counts": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(data, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return data


def diff_findings(findings: Sequence[Finding],
                  baseline: Counter) -> list[Finding]:
    """Findings NOT covered by the baseline multiset: the i-th repeat of
    a key is new once i exceeds the baselined count."""
    seen: Counter = Counter()
    new: list[Finding] = []
    for f in findings:
        seen[f.key] += 1
        if seen[f.key] > baseline.get(f.key, 0):
            new.append(f)
    return new
