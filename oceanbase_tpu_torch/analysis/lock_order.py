"""lock-order checker: acquisition-graph inversions and unlocked shared
mutation (rules ``lock.*``).

Scope: the concurrent control plane — ``catalog.py``,
``storage/engine.py`` (+ the tablet/memtable/indexes structures it locks
through), ``net/node.py``, ``tx/*.py``, ``server/tenant.py``.  The
checker:

1. finds lock objects (``self.X = threading.Lock()/RLock()/Condition()``)
   — a lock's identity is ``Class.attr``;
2. walks every method tracking the held-lock stack through ``with``
   blocks (and linear ``.acquire()``/``.release()`` pairs), resolving
   calls through ``self.``, typed attributes (``self.attr = Class()``
   anywhere in scope) and unique method names, to build the
   lock-acquisition graph with per-edge witness sites; a method named
   ``*_locked`` is analyzed with its class locks held (the codebase's
   caller-holds-the-lock convention);
3. reports every cycle as ``lock.inversion`` (two threads taking the
   edges in opposite order deadlock);
4. reports container mutation of shared ``self.*`` state outside any
   held lock in lock-owning classes as ``lock.unlocked-mut``.
"""

from __future__ import annotations

import ast
import fnmatch
from dataclasses import dataclass

from oceanbase_tpu_torch.analysis.core import Analyzer, Finding, dotted_name

SCOPE = (
    "oceanbase_tpu_torch/catalog.py",
    "oceanbase_tpu_torch/storage/engine.py",
    "oceanbase_tpu_torch/storage/tablet.py",
    "oceanbase_tpu_torch/storage/partition.py",
    "oceanbase_tpu_torch/storage/memtable.py",
    "oceanbase_tpu_torch/storage/indexes.py",
    "oceanbase_tpu_torch/net/node.py",
    "oceanbase_tpu_torch/tx/*.py",
    "oceanbase_tpu_torch/server/tenant.py",
)

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
_MUTATORS = {"pop", "append", "update", "add", "remove", "clear",
             "discard", "setdefault", "popitem", "insert", "extend"}
_CONTAINER_CTORS = {"dict", "list", "set", "defaultdict", "OrderedDict",
                    "Counter", "deque"}


@dataclass
class _AssignView:
    """Uniform (targets, value) view over Assign/AnnAssign nodes."""

    targets: list
    value: ast.AST


@dataclass
class _Method:
    path: str
    cls: str
    name: str
    node: ast.FunctionDef

    @property
    def qual(self) -> str:
        return f"{self.cls}.{self.name}"


class _Scope:
    def __init__(self, az: Analyzer):
        self.az = az
        self.paths = sorted(
            p for p in az.trees
            if any(fnmatch.fnmatch(p, pat) for pat in SCOPE))
        self.methods: dict[tuple[str, str], _Method] = {}  # (cls,name)
        self.by_method_name: dict[str, list[tuple[str, str]]] = {}
        self.functions: dict[str, tuple[str, ast.FunctionDef]] = {}
        self.locks: dict[str, set[str]] = {}       # cls -> lock attrs
        self.attr_type: dict[str, str] = {}        # attr name -> cls
        self.containers: dict[str, set[str]] = {}  # cls -> dict/list attrs
        cls_names: set[str] = set()
        for path in self.paths:
            for n in self.az.trees[path].body:
                if isinstance(n, ast.ClassDef):
                    cls_names.add(n.name)
        for path in self.paths:
            for n in self.az.trees[path].body:
                if isinstance(n, ast.ClassDef):
                    self._scan_class(path, n, cls_names)
                elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.functions[n.name] = (path, n)
                    self._scan_attr_types(n, cls_names)

    def _scan_class(self, path: str, cnode: ast.ClassDef,
                    cls_names: set[str]):
        self.locks.setdefault(cnode.name, set())
        self.containers.setdefault(cnode.name, set())
        for m in cnode.body:
            if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            meth = _Method(path, cnode.name, m.name, m)
            self.methods[(cnode.name, m.name)] = meth
            self.by_method_name.setdefault(m.name, []).append(
                (cnode.name, m.name))
            for n in ast.walk(m):
                if isinstance(n, ast.Assign):
                    tgts, val = n.targets, n.value
                elif isinstance(n, ast.AnnAssign) and n.value is not None:
                    tgts, val = [n.target], n.value
                else:
                    continue
                n = _AssignView(tgts, val)
                self_attrs = [
                    t.attr for t in n.targets
                    if isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"]
                if not self_attrs:
                    continue
                if isinstance(n.value, (ast.Dict, ast.List, ast.Set,
                                        ast.DictComp, ast.ListComp)):
                    self.containers[cnode.name].update(self_attrs)
                elif isinstance(n.value, ast.Call):
                    d = dotted_name(n.value.func) or ""
                    last = d.split(".")[-1]
                    if last in _LOCK_CTORS:
                        self.locks[cnode.name].update(self_attrs)
                    elif last in cls_names:
                        for a in self_attrs:
                            self.attr_type[a] = last
                    elif last in _CONTAINER_CTORS:
                        self.containers[cnode.name].update(self_attrs)
            self._scan_attr_types(m, cls_names)

    def _scan_attr_types(self, fnode, cls_names: set[str]):
        """``<anything>.attr = ClassName(...)`` anywhere in scope types
        the attribute (covers late wiring like svc.lock_table = ...)."""
        for n in ast.walk(fnode):
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                last = (dotted_name(n.value.func) or "").split(".")[-1]
                if last not in cls_names:
                    continue
                for t in n.targets:
                    if isinstance(t, ast.Attribute):
                        self.attr_type.setdefault(t.attr, last)

    # -- lock identity ---------------------------------------------------
    def lock_of(self, cls: str, expr: ast.AST) -> str | None:
        """``self.X`` (or ``<name>.X``) naming a known lock attr."""
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and expr.attr in self.locks.get(
                        cls, ()):
                    return f"{cls}.{expr.attr}"
                # cond.wait()/x._lock style receivers: match any class
                # holding a lock attr of this name via typed attributes
                owner = self.attr_type.get(base.id)
                if owner and expr.attr in self.locks.get(owner, ()):
                    return f"{owner}.{expr.attr}"
        return None

    # -- call resolution -------------------------------------------------
    def resolve(self, cls: str, call: ast.Call) -> list[tuple[str, str]]:
        f = call.func
        if isinstance(f, ast.Name):
            if f.id in self.functions:
                return [("", f.id)]  # module-level function
            return []
        if not isinstance(f, ast.Attribute):
            return []
        base = f.value
        if isinstance(base, ast.Name) and base.id == "self":
            if (cls, f.attr) in self.methods:
                return [(cls, f.attr)]
            return []
        # typed attribute receiver: self.attr.m() / svc.attr.m()
        if isinstance(base, ast.Attribute):
            owner = self.attr_type.get(base.attr)
            if owner and (owner, f.attr) in self.methods:
                return [(owner, f.attr)]
            return []
        # bare-name receiver: resolve only when the method name is
        # specific (defined by at most 2 scoped classes) — generic names
        # like get/write on arbitrary receivers would fabricate edges
        if isinstance(base, ast.Name):
            owner = self.attr_type.get(base.id)
            if owner and (owner, f.attr) in self.methods:
                return [(owner, f.attr)]
            cands = self.by_method_name.get(f.attr, [])
            if 0 < len(cands) <= 2:
                return list(cands)
        return []


# ---------------------------------------------------------------------------
# per-method walk: held-lock stack + events
# ---------------------------------------------------------------------------


@dataclass
class _Summary:
    acquires: set[str]
    calls: list[tuple[tuple[str, str], int]]  # (callee, line)
    # (held, acquired, line) for direct nested acquisition
    nested: list[tuple[str, str, int]]
    # calls made while holding: (held locks, callee, line)
    held_calls: list[tuple[frozenset, tuple[str, str], int]]
    # shared-container mutations outside any lock: (attr, line, how)
    unlocked_muts: list[tuple[str, int, str]]


def _mutated_self_attr(node: ast.AST) -> tuple[str, str] | None:
    """Container mutation of ``self.<attr>`` -> (attr, kind)."""
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
            and node.func.attr in _MUTATORS:
        recv = node.func.value
        if isinstance(recv, ast.Attribute) and \
                isinstance(recv.value, ast.Name) and recv.value.id == "self":
            return recv.attr, f".{node.func.attr}()"
    tgts: list[ast.AST] = []
    if isinstance(node, ast.Assign):
        tgts = list(node.targets)
    elif isinstance(node, ast.AugAssign):
        tgts = [node.target]
    elif isinstance(node, ast.Delete):
        tgts = list(node.targets)
    for t in tgts:
        while isinstance(t, ast.Subscript):
            t = t.value
            if isinstance(t, ast.Attribute) and \
                    isinstance(t.value, ast.Name) and t.value.id == "self":
                return t.attr, "[...] store"
    return None


def _stmt_exprs(st: ast.stmt):
    """The statement's own expression children (bodies excluded — those
    are visited as statements with their own held set)."""
    for _name, val in ast.iter_fields(st):
        if isinstance(val, ast.expr):
            yield val
        elif isinstance(val, list):
            for v in val:
                if isinstance(v, ast.expr):
                    yield v


def _walk(scope: _Scope, meth: _Method, summ: _Summary):
    lock_attrs = scope.locks.get(meth.cls, set())
    container_attrs = scope.containers.get(meth.cls, set())

    def record_mut(attr_how, line, held):
        attr, how = attr_how
        # only KNOWN shared containers: self.obj.append() on a component
        # object is a method call, that object's own lock's concern
        if not held and lock_attrs and attr in container_attrs:
            summ.unlocked_muts.append((attr, line, how))

    def scan_expr(expr: ast.AST, held: tuple[str, ...]):
        for n in ast.walk(expr):
            if not isinstance(n, ast.Call):
                continue
            if isinstance(n.func, ast.Attribute) and n.func.attr in (
                    "acquire", "release", "wait", "notify",
                    "notify_all") and scope.lock_of(
                        meth.cls, n.func.value) is not None:
                if n.func.attr == "acquire":
                    lk = scope.lock_of(meth.cls, n.func.value)
                    for h in held:
                        if h != lk:
                            summ.nested.append((h, lk, n.lineno))
                    summ.acquires.add(lk)
                continue
            mut = _mutated_self_attr(n)
            if mut is not None:
                record_mut(mut, n.lineno, held)
                continue
            for tgt in scope.resolve(meth.cls, n):
                summ.calls.append((tgt, n.lineno))
                if held:
                    summ.held_calls.append(
                        (frozenset(held), tgt, n.lineno))

    def visit(stmts, held: tuple[str, ...]):
        held_list = list(held)
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # nested defs are separate analysis units
            if isinstance(st, ast.With):
                new = list(held_list)
                for item in st.items:
                    lk = scope.lock_of(meth.cls, item.context_expr)
                    if lk is not None:
                        for h in new:
                            if h != lk:
                                summ.nested.append((h, lk, st.lineno))
                        summ.acquires.add(lk)
                        new.append(lk)
                    else:
                        scan_expr(item.context_expr, tuple(held_list))
                visit(st.body, tuple(new))
                continue
            # linear acquire()/release() statements on our own locks
            if isinstance(st, ast.Expr) and isinstance(st.value, ast.Call):
                c = st.value
                if isinstance(c.func, ast.Attribute) and \
                        c.func.attr in ("acquire", "release"):
                    lk = scope.lock_of(meth.cls, c.func.value)
                    if lk is not None:
                        if c.func.attr == "acquire":
                            for h in held_list:
                                if h != lk:
                                    summ.nested.append((h, lk, st.lineno))
                            summ.acquires.add(lk)
                            held_list.append(lk)
                        elif lk in held_list:
                            held_list.remove(lk)
                        continue
            mut = _mutated_self_attr(st)
            if mut is not None:
                record_mut(mut, st.lineno, tuple(held_list))
            for expr in _stmt_exprs(st):
                scan_expr(expr, tuple(held_list))
            for fld in ("body", "orelse", "finalbody"):
                sub = getattr(st, fld, None)
                if sub:
                    visit(sub, tuple(held_list))
            for h in getattr(st, "handlers", []) or []:
                visit(h.body, tuple(held_list))

    # the ``_locked`` suffix is the codebase's caller-holds-the-lock
    # convention: analyze the body as if every class lock were held
    # (mutations are covered; calls out still contribute edges FROM the
    # held locks, which is exactly what the caller's context implies)
    initial: tuple[str, ...] = ()
    if meth.name.endswith("_locked"):
        initial = tuple(f"{meth.cls}.{a}" for a in sorted(lock_attrs))
        summ.acquires.update(initial)
    visit(meth.node.body, initial)


def check_lock_order(az: Analyzer) -> list[Finding]:
    scope = _Scope(az)
    summaries: dict[tuple[str, str], _Summary] = {}
    for key, meth in scope.methods.items():
        s = _Summary(set(), [], [], [], [])
        _walk(scope, meth, s)
        summaries[key] = s
    # module-level functions participate in resolution targets
    for name, (path, fnode) in scope.functions.items():
        meth = _Method(path, "", name, fnode)
        s = _Summary(set(), [], [], [], [])
        _walk(scope, meth, s)
        summaries[("", name)] = s

    # transitive acquisition sets (fixpoint)
    changed = True
    trans: dict[tuple[str, str], set[str]] = {
        k: set(s.acquires) for k, s in summaries.items()}
    while changed:
        changed = False
        for k, s in summaries.items():
            for callee, _ln in s.calls:
                extra = trans.get(callee, set()) - trans[k]
                if extra:
                    trans[k] |= extra
                    changed = True

    # lock graph edges with witnesses
    edges: dict[tuple[str, str], tuple[str, int, str]] = {}

    def add_edge(a: str, b: str, path: str, line: int, qual: str):
        if a != b and (a, b) not in edges:
            edges[(a, b)] = (path, line, qual)

    for key, s in summaries.items():
        meth = scope.methods.get(key)
        path = meth.path if meth else scope.functions[key[1]][0]
        qual = meth.qual if meth else key[1]
        for h, lk, ln in s.nested:
            add_edge(h, lk, path, ln, qual)
        for held, callee, ln in s.held_calls:
            for h in held:
                for lk in trans.get(callee, ()):
                    add_edge(h, lk, path, ln, qual)

    findings: list[Finding] = []

    # cycle detection over the lock graph
    adj: dict[str, set[str]] = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)

    def find_cycles() -> list[tuple[str, ...]]:
        cycles: set[tuple[str, ...]] = set()
        for start in sorted(adj):
            stack = [(start, (start,))]
            while stack:
                node, trail = stack.pop()
                for nxt in sorted(adj.get(node, ())):
                    if nxt == start:
                        # canonical rotation for stable identity
                        cyc = trail
                        i = cyc.index(min(cyc))
                        cycles.add(cyc[i:] + cyc[:i])
                    elif nxt not in trail and len(trail) < 6:
                        stack.append((nxt, trail + (nxt,)))
        return sorted(cycles)

    for cyc in find_cycles():
        a, b = cyc[0], cyc[1 % len(cyc)]
        wit = edges.get((a, b)) or next(iter(edges.values()))
        path, line, qual = wit
        order = " -> ".join(cyc + (cyc[0],))
        findings.append(Finding(
            "lock.inversion", path, line, qual,
            f"lock-order cycle {order}: two threads taking these in "
            f"opposite order deadlock"))

    for key, s in summaries.items():
        meth = scope.methods.get(key)
        if meth is None:
            continue
        seen: set[tuple[str, str]] = set()
        for attr, line, how in s.unlocked_muts:
            if meth.name.startswith("__init__"):
                continue
            if (attr, how) in seen:  # one finding per attr/kind per method
                continue
            seen.add((attr, how))
            findings.append(Finding(
                "lock.unlocked-mut", meth.path, line, meth.qual,
                f"self.{attr}{how} mutates shared state outside "
                f"{meth.cls}'s lock"))
    return findings
