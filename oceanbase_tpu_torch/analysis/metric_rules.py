"""metric checker: metrics-plane discipline (rules ``metric.*``).

The metrics registry (server/metrics.py) buys its ≤2% overhead budget
with two contracts this checker enforces statically:

- **host-side only** (``metric.jit-reachable``, the reference's id) — a
  metric update inside an execution's device scope is host work on every
  operator of every execution in eager torch, and under a CUDA graph
  capture it would run once at capture (silently wrong counts, the
  reference's jit bug); updates belong at the same result/span-close
  boundaries the trace spans instrument.  The scope is the SAME closure
  trace_safety uses: functions reachable from its ``EXECUTION_ROOTS``.
- **declared names only** (``metric.undeclared`` /
  ``metric.dynamic-name``) — every series name passed to
  ``inc``/``observe``/``set_gauge`` must be a string literal registered
  by a ``declare(...)`` call somewhere in the package (or a module-level
  constant bound to a ``declare(...)`` result).  A dynamically formatted
  name (f-string, ``%``/``+``/``.format`` build, loop variable) can typo
  itself into a fresh series that nothing ever reads — the cardinality
  leak Prometheus operators know too well.

Both rules fire only on calls that resolve to the metrics module
(``from oceanbase_tpu_torch.server import metrics [as qmetrics]`` attribute
calls, or names from-imported out of ``oceanbase_tpu_torch.server.metrics``);
an unrelated object's ``.observe(...)`` is not our business.
"""

from __future__ import annotations

import ast

from oceanbase_tpu_torch.analysis.core import Analyzer, Finding
from oceanbase_tpu_torch.analysis.trace_safety import _Index, device_scope

METRICS_MODULE = "oceanbase_tpu_torch.server.metrics"
UPDATE_FNS = ("inc", "observe", "set_gauge")


def _metrics_aliases(idx: _Index, path: str) -> set[str]:
    """Local names that refer to the metrics MODULE in ``path``
    (``import ... as qmetrics`` / ``from oceanbase_tpu_torch.server import
    metrics``)."""
    out: set[str] = set()
    for alias, mod in idx.alias.get(path, {}).items():
        if mod == METRICS_MODULE:
            out.add(alias)
    for alias, (mod, orig) in idx.from_imp.get(path, {}).items():
        if f"{mod}.{orig}" == METRICS_MODULE:
            out.add(alias)
    return out


def _direct_imports(idx: _Index, path: str) -> dict[str, str]:
    """{local name: metrics function} for ``from ...metrics import inc``."""
    out: dict[str, str] = {}
    for alias, (mod, orig) in idx.from_imp.get(path, {}).items():
        if mod == METRICS_MODULE and orig in UPDATE_FNS + ("declare",):
            out[alias] = orig
    return out


def _classify_call(idx: _Index, path: str, call: ast.Call) -> str | None:
    """-> 'inc' | 'observe' | 'set_gauge' | 'declare' when ``call`` is a
    metrics-module call, else None."""
    f = call.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        if f.value.id in _metrics_aliases(idx, path) and \
                f.attr in UPDATE_FNS + ("declare",):
            return f.attr
        return None
    if isinstance(f, ast.Name):
        return _direct_imports(idx, path).get(f.id)
    return None


def _declared_names(idx: _Index) -> tuple[set[str], set[tuple[str, str]]]:
    """Collect the registry: literal first arguments of every
    ``declare(...)`` call, plus (path, name) pairs for module-level
    constants bound to a declare() result (``M_FOO = declare("foo",
    ...)`` — declare returns the name)."""
    names: set[str] = set()
    consts: set[tuple[str, str]] = set()
    for path, tree in idx.az.trees.items():
        for n in ast.walk(tree):
            if isinstance(n, ast.Call) and \
                    _classify_call(idx, path, n) == "declare":
                if n.args and isinstance(n.args[0], ast.Constant) \
                        and isinstance(n.args[0].value, str):
                    names.add(n.args[0].value)
            if isinstance(n, ast.Assign) and \
                    isinstance(n.value, ast.Call) and \
                    _classify_call(idx, path, n.value) == "declare":
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        consts.add((path, t.id))
    return names, consts


def check_metric_rules(az: Analyzer) -> list[Finding]:
    idx = _Index(az)
    scope = device_scope(idx)
    declared, consts = _declared_names(idx)
    # metrics.py itself implements the registry — its internal calls are
    # the machinery, not call sites
    metrics_path = None
    for p in az.trees:
        if p.endswith("server/metrics.py"):
            metrics_path = p
    out: list[Finding] = []
    for (path, qual), info in idx.funcs.items():
        if path == metrics_path:
            continue
        for call in info.calls:
            kind = _classify_call(idx, path, call)
            if kind is None or kind == "declare":
                continue
            if (path, qual) in scope:
                out.append(Finding(
                    "metric.jit-reachable", path, call.lineno, qual,
                    f"metrics.{kind}(...) in an execution's device scope: "
                    f"host work per operator (and one count per CUDA "
                    f"graph capture) — move it to the result boundary"))
            if not call.args:
                continue
            a = call.args[0]
            if isinstance(a, ast.Constant) and isinstance(a.value, str):
                if a.value not in declared:
                    out.append(Finding(
                        "metric.undeclared", path, call.lineno, qual,
                        f"metric name {a.value!r} was never "
                        f"declare()d: updates to it raise at runtime"))
            elif isinstance(a, ast.Name) and (path, a.id) in consts:
                pass  # module-level NAME = declare("...") constant
            else:
                out.append(Finding(
                    "metric.dynamic-name", path, call.lineno, qual,
                    f"dynamically built metric name "
                    f"({ast.unparse(a)[:60]}): a typo mints a fresh "
                    f"series silently — use a declared literal (put "
                    f"variability in labels)"))
    return out
