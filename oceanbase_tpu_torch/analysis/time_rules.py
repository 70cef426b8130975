"""time checker: monotonic-clock discipline (rules ``time.*``).

The timing contract — ``time.time()`` is a RECORD timestamp,
elapsed measurements come from ``time.monotonic()`` /
``time.perf_counter()``.  This checker makes it static:

- **``time.wall-elapsed``** — subtracting two wall-clock samples taken
  in the same code (``time.time() - t0`` where ``t0 = time.time()``, or
  ``t1 - t0`` with both wall locals) measures elapsed time with a clock
  that steps under NTP adjustment: a latency histogram can record
  negative or hour-long "durations" during a step.  Only LOCAL wall
  samples pair into a finding — ``time.time() - record.ts`` is an
  age-of-record computation against a stored timestamp and stays legal
  (stored wall timestamps are the only thing that survives a restart).

Audited exceptions carry ``# obcheck: ok(time.wall-elapsed)``; the
baseline ships empty — the tree is clean and must stay so.
"""

from __future__ import annotations

import ast

from oceanbase_tpu_torch.analysis.core import Analyzer, Finding


def _time_module_aliases(tree: ast.Module) -> tuple[set[str], set[str]]:
    """-> (names bound to the ``time`` MODULE, names bound to the
    ``time.time`` FUNCTION) at any import site in the file."""
    mods: set[str] = set()
    fns: set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Import):
            for a in n.names:
                if a.name == "time":
                    mods.add(a.asname or "time")
        elif isinstance(n, ast.ImportFrom):
            if n.module == "time":
                for a in n.names:
                    if a.name == "time":
                        fns.add(a.asname or "time")
    return mods, fns


def _is_wall_call(node, mods: set[str], fns: set[str]) -> bool:
    """Is ``node`` a direct ``time.time()`` / imported ``time()`` call?"""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        return f.value.id in mods and f.attr == "time"
    if isinstance(f, ast.Name):
        return f.id in fns
    return False


def check_time_rules(az: Analyzer) -> list[Finding]:
    out: list[Finding] = []
    for path, tree in az.trees.items():
        mods, fns = _time_module_aliases(tree)
        if not mods and not fns:
            continue

        def scan_scope(body_nodes, qual, inherited: frozenset):
            """One function (or module/class) scope: collect locals
            assigned from wall-clock calls, then flag subtractions
            pairing two wall samples.  ``inherited`` carries enclosing
            scopes' wall names (closures)."""
            wall = set(inherited)
            subs = []
            nested = []  # (child scope body, child qual)

            def visit(node):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    sep = ".<locals>." if qual else ""
                    nested.append((node.body, f"{qual}{sep}{node.name}"))
                    return  # its body is its own scope
                if isinstance(node, ast.ClassDef):
                    # a class body is not a closure scope: its methods
                    # get Class.method qualnames with a fresh wall set
                    for c in node.body:
                        if isinstance(c, (ast.FunctionDef,
                                          ast.AsyncFunctionDef)):
                            nested.append(
                                (c.body, f"{node.name}.{c.name}"))
                        else:
                            visit(c)
                    return
                if isinstance(node, ast.Assign) and \
                        _is_wall_call(node.value, mods, fns):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            wall.add(t.id)
                if isinstance(node, ast.AnnAssign) and \
                        node.value is not None and \
                        _is_wall_call(node.value, mods, fns) and \
                        isinstance(node.target, ast.Name):
                    wall.add(node.target.id)
                if isinstance(node, ast.BinOp) and \
                        isinstance(node.op, ast.Sub):
                    subs.append(node)
                for c in ast.iter_child_nodes(node):
                    visit(c)

            for n in body_nodes:
                visit(n)

            def is_wall_sample(e) -> bool:
                if _is_wall_call(e, mods, fns):
                    return True
                return isinstance(e, ast.Name) and e.id in wall

            for s in subs:
                if is_wall_sample(s.left) and is_wall_sample(s.right):
                    out.append(Finding(
                        "time.wall-elapsed", path, s.lineno, qual,
                        "elapsed measured as a wall-clock delta "
                        f"({ast.unparse(s)[:60]}): time.time() steps "
                        "under NTP — use time.monotonic() / "
                        "perf_counter() for durations (wall stays for "
                        "record timestamps)"))
            frozen = frozenset(wall)
            for child_body, child_qual in nested:
                scan_scope(child_body, child_qual, frozen)

        scan_scope(tree.body, "", frozenset())
    return out
