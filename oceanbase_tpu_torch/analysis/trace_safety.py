"""trace-safety checker for the port: host syncs and cache-key hazards
(rules ``trace.*``).

The port's executor is eager torch: every operator launches on the CUDA
stream and returns at once, and the host stays ahead of the card until
something makes it wait.  One execution may wait once, at its result
boundary (ROADMAP, "Port contracts"); anything else that waits stalls
the stream for the host's launch latency per call.  The rule ids are
the reference's, with their torch meaning:

- ``trace.host-sync`` — a call that blocks the host on the stream:
  ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``,
  ``int()/float()/bool()`` of a tensor, ``np.asarray/np.array`` of a
  tensor, ``torch.cuda.synchronize`` and ``Event``/``Stream``
  ``.synchronize()``, ``torch.equal``/``allclose``; the ops whose output
  shape depends on the data (``nonzero``, ``unique``, ``masked_select``,
  ``bincount``, one-argument ``torch.where``, ``repeat_interleave`` with
  tensor repeats and no ``output_size`` — a traced JAX body refused
  them, so the reference needed no rule); and an upload from pageable
  host memory (``torch.from_numpy(...).to(dev)`` without
  ``non_blocking``, ``torch.tensor``/``torch.as_tensor`` with
  ``device=``), which ``torch.cuda.set_sync_debug_mode`` reports too.
- ``trace.tracer-branch`` — a Python ``if``/``while`` on a tensor-valued
  expression inside the device scope: an implicit ``bool()``, so a sync.
- ``trace.cache-key`` — an identity-hashed or mutable object in an
  ``lru_cache`` key: the per-signature caches mint a fresh entry per
  instance even when nothing changed (unchanged from the reference).
- ``trace.unknown-root`` — an ``EXECUTION_ROOTS`` or ``ENTRY_POINTS``
  entry naming a function that no longer exists: a rename would
  otherwise shrink the scope silently.

Scope is declared, not computed: eager torch has no ``jax.jit`` root to
find.  ``EXECUTION_ROOTS`` names the functions that run one execution's
device work (each beside the reference root it stands for); the *device
scope* is their transitive call closure.  ``ENTRY_POINTS`` names the
public functions that run an execution; their closure outside the
device scope is the execution's *host half* (the overflow read, the
ring's waits), where every sync pattern is flagged as in the device
scope.  Everywhere else a small intraprocedural taint marks the results
of calling an entry point or a scoped function as tensors on the card,
so ``out, ovf = execute_...(...); int(ovf)`` is flagged in the caller;
the data-dependent-shape ``torch.*`` ops are flagged package-wide.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from oceanbase_tpu_torch.analysis.core import (
    Analyzer,
    Finding,
    dotted_name,
    iter_functions,
)

_P = "oceanbase_tpu_torch/"

#: path -> qualname -> the reference roots it stands for (reference
#: paths under ``oceanbase_tpu/``).  The device scope is the call closure
#: of these functions.  The reference's sorted-stream and spill-scan
#: chunk bodies have no function of their own here: the port runs their
#: chunk plan (``Compact`` over the scan subtree) through ``_lower``.
EXECUTION_ROOTS: dict[str, dict[str, tuple[str, ...]]] = {
    _P + "exec/plan.py": {
        "_lower_inner": (
            "exec/plan.py::_PlanExecutable.__init__.<locals>.run",
            "exec/granule.py::execute_sorted_streamed.<locals>.chunk_fn",
            "exec/spill_exec.py::_scan_batches.<locals>.chunk_fn"),
    },
    _P + "exec/granule.py": {
        "execute_streamed.<locals>.chunk_fn": (
            "exec/granule.py::execute_streamed.<locals>.chunk_fn",),
    },
    _P + "px/planner.py": {
        "_dlower": ("px/planner.py::_px_compiled.<locals>.shard_body",),
    },
    _P + "px/dist_ops.py": {
        "dist_groupby_shard": ("px/dist_ops.py::dist_groupby.<locals>.fn",),
    },
    _P + "server/calibrate.py": {
        "probe_cases.<locals>.build_seg.<locals>.fn": (
            "server/calibrate.py::probe_cases.<locals>.build_seg"
            ".<locals>.fn",),
    },
    _P + "share/vector_index.py": {
        "exact_search": ("share/vector_index.py::exact_search",),
        "_kmeans": ("share/vector_index.py::_kmeans",),
        "_ivf_search": ("share/vector_index.py::_ivf_search",),
    },
    _P + "ops/scan_kernels.py": {
        "q6_filter_sum": ("ops/scan_kernels.py::q6_filter_sum",),
    },
}

#: path -> the public functions that run an execution.  Their results
#: are tensors on the card in a caller; their closure outside the device
#: scope (and short of ``BOUNDARIES``) is the execution's host half.
ENTRY_POINTS: dict[str, tuple[str, ...]] = {
    _P + "exec/plan.py": ("execute_plan",),
    _P + "exec/granule.py": ("execute_streamed", "execute_sorted_streamed"),
    _P + "exec/spill_exec.py": ("execute_spilled",),
    _P + "px/planner.py": ("execute_plan_distributed",),
    _P + "px/dist_ops.py": ("dist_groupby",),
}

#: path -> qualname -> why: where rows cross between the host and the
#: card.  The copy there is the transfer itself, not a stall inside the
#: execution, so the host half stops at these functions.
BOUNDARIES: dict[str, dict[str, str]] = {
    _P + "vector/column.py": {
        "to_numpy": "the result boundary: live rows leave the card",
        "from_numpy": "the input boundary: host columns arrive",
    },
    _P + "px/dtl.py": {
        "execute_fragment": "a DTL slice's boundary: the replica's host "
                            "snapshot goes up, the reply's rows come back "
                            "for the wire",
        "merge_fragments": "the coordinator's exchange boundary: the "
                           "replies' host rows go up for the final merge",
    },
}

# numpy module aliases whose asarray/array force device->host transfer
NP_ALIASES = {"np", "numpy"}
SYNC_BUILTINS = {"int", "float", "bool"}
# an argument mentioning any of these is static/aux metadata, not data
STATIC_MARKERS = {
    "shape", "ndim", "size", "itemsize", "capacity", "sdict", "values",
    "scale", "precision", "dtype", "np_dtype", "kind", "len", "math",
    "iinfo", "finfo", "axis_names", "devices", "device_count", "fields",
    "maxsize", "environ", "time", "monotonic", "perf_counter",
    # torch's host-side metadata
    "numel", "dim", "device", "element_size", "data_ptr", "is_cuda",
}
# payload attributes of a Column/Relation: tensors on the card
PAYLOAD_ATTRS = ("data", "mask", "valid")
# torch.<name>(...) calls that do not return a tensor on the card
_TORCH_NON_TENSOR = {
    "cuda", "backends", "device", "iinfo", "finfo", "Size", "Generator",
    "manual_seed", "get_default_dtype", "set_default_dtype",
    "get_num_threads", "set_num_threads", "is_tensor", "is_floating_point",
    "is_complex", "promote_types", "result_type", "can_cast", "profiler",
    "distributed", "utils", "autograd", "no_grad", "inference_mode",
    "enable_grad", "_C", "ops", "library", "jit", "compile", "dtype",
    "typename", "is_grad_enabled", "set_grad_enabled", "equal",
    "allclose", "use_deterministic_algorithms", "get_rng_state",
    "set_rng_state", "from_numpy", "version",
}
# ops whose output shape depends on the data: the host waits for it
_DATA_SHAPE_FNS = {"nonzero", "unique", "unique_consecutive",
                   "masked_select", "bincount", "argwhere"}
# torch calls that return a Python bool read off the card
_TORCH_BOOL_FNS = {"equal", "allclose", "is_nonzero"}
# methods that copy a tensor to the host
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")


def _module_of(path: str) -> str:
    mod = path[:-3] if path.endswith(".py") else path
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


@dataclass
class _FuncInfo:
    path: str
    qual: str
    node: ast.AST
    cls: str | None
    calls: list[ast.Call] = field(default_factory=list)


class _Index:
    """Cross-file function/class/import index with best-effort call
    resolution (precise enough for reachability, never raising)."""

    def __init__(self, az: Analyzer):
        self.az = az
        self.funcs: dict[tuple[str, str], _FuncInfo] = {}
        self.by_name: dict[str, dict[str, list[str]]] = {}  # path->name->quals
        self.classes: dict[str, dict[str, ast.ClassDef]] = {}
        self.mod_to_path = {_module_of(p): p for p in az.trees}
        # per-path import maps (module level + function local, merged)
        self.alias: dict[str, dict[str, str]] = {}       # alias -> module
        self.from_imp: dict[str, dict[str, tuple[str, str]]] = {}
        for path, tree in az.trees.items():
            self.classes[path] = {
                n.name: n for n in ast.walk(tree)
                if isinstance(n, ast.ClassDef)}
            al: dict[str, str] = {}
            fi: dict[str, tuple[str, str]] = {}
            for n in ast.walk(tree):
                if isinstance(n, ast.Import):
                    for a in n.names:
                        al[a.asname or a.name.split(".")[0]] = a.name
                elif isinstance(n, ast.ImportFrom) and n.module:
                    for a in n.names:
                        fi[a.asname or a.name] = (n.module, a.name)
            self.alias[path] = al
            self.from_imp[path] = fi
            names: dict[str, list[str]] = {}
            for qual, fnode, cls in iter_functions(tree):
                info = _FuncInfo(path, qual, fnode, cls)
                info.calls = [c for c in ast.walk(fnode)
                              if isinstance(c, ast.Call)]
                self.funcs[(path, qual)] = info
                names.setdefault(qual.split(".")[-1], []).append(qual)
            self.by_name[path] = names

    # -- resolution ------------------------------------------------------
    def resolve_call(self, path: str, call: ast.Call
                     ) -> list[tuple[str, str]]:
        """Call node -> candidate (path, qualname) targets in the file
        set.  Bare names resolve in-module then via from-imports; dotted
        ``mod.fn`` resolves only through known module aliases; ``self.m``
        resolves within the enclosing class's file."""
        f = call.func
        if isinstance(f, ast.Name):
            return self._resolve_name(path, f.id)
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name):
                if base.id in ("self", "cls"):
                    # any method of this name in the same file (class
                    # attribution is approximate but file-local)
                    return [(path, q)
                            for q in self.by_name[path].get(f.attr, [])
                            if "." in q]
                mod = self.alias[path].get(base.id)
                if mod is None and base.id in self.from_imp[path]:
                    src_mod, orig = self.from_imp[path][base.id]
                    mod = f"{src_mod}.{orig}"
                if mod is not None:
                    tp = self.mod_to_path.get(mod) or self.mod_to_path.get(
                        mod + ".__init__")
                    if tp is not None:
                        return [(tp, q)
                                for q in self.by_name[tp].get(f.attr, [])]
                    return []  # external module: not ours
            # unknown receiver: unresolved (keeps the scope tight)
            return []
        return []

    def _resolve_name(self, path: str, name: str) -> list[tuple[str, str]]:
        out = [(path, q) for q in self.by_name[path].get(name, [])]
        if out:
            return out
        imp = self.from_imp[path].get(name)
        for _ in range(3):  # follow a package's re-exports a few hops
            if imp is None:
                return []
            mod, orig = imp
            tp = self.mod_to_path.get(mod) or self.mod_to_path.get(
                mod + ".__init__")
            if tp is None:
                return []
            out = [(tp, q) for q in self.by_name[tp].get(orig, [])]
            if out:
                return out
            imp = self.from_imp[tp].get(orig)
        return []

    def torch_aliases(self, path: str) -> set[str]:
        return {a for a, m in self.alias[path].items() if m == "torch"}


def _registered(idx: _Index, reg) -> tuple[set, list[tuple[str, str]]]:
    """-> (registered (path, qual) keys present in the tree, entries whose
    path is analyzed but whose function is gone)."""
    found, missing = set(), []
    for path, quals in reg.items():
        if path not in idx.az.trees:
            continue  # a module the tree lacks: applies when it lands
        for qual in quals:
            if (path, qual) in idx.funcs:
                found.add((path, qual))
            else:
                missing.append((path, qual))
    return found, missing


def _closure(idx: _Index, roots, stop=frozenset()
             ) -> set[tuple[str, str]]:
    """Transitive call closure of ``roots``, not descending into
    ``stop``."""
    scope = set(roots)
    work = list(roots)
    while work:
        info = idx.funcs.get(work.pop())
        if info is None:
            continue
        for call in info.calls:
            for tgt in idx.resolve_call(info.path, call):
                if tgt not in scope and tgt not in stop:
                    scope.add(tgt)
                    work.append(tgt)
    return scope


def device_scope(idx: _Index) -> set[tuple[str, str]]:
    """Transitive call closure of the registered execution roots."""
    return _closure(idx, _registered(idx, EXECUTION_ROOTS)[0])


# ---------------------------------------------------------------------------
# tensors: what a name holds
# ---------------------------------------------------------------------------


def _refs(node: ast.AST, tainted: set[str]) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and n.id in tainted:
            return True
    return False


def _target_names(t: ast.AST) -> list[str]:
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        out: list[str] = []
        for e in t.elts:
            out.extend(_target_names(e))
        return out
    if isinstance(t, ast.Starred):
        return _target_names(t.value)
    return []


def _mentions_static(node: ast.AST) -> bool:
    """Does the expression read host metadata (``x.shape[0]``,
    ``len(...)``)?  Keyword arguments are passed over: ``dtype=`` and
    ``device=`` ride on every tensor constructor."""
    stack = [node]
    while stack:
        n = stack.pop()
        if isinstance(n, ast.keyword):
            continue
        if isinstance(n, ast.Attribute) and n.attr in STATIC_MARKERS:
            return True
        if isinstance(n, ast.Name) and n.id in STATIC_MARKERS:
            return True
        stack.extend(ast.iter_child_nodes(n))
    return False


def _torch_fn(call: ast.Call, torch_names: set[str]) -> str | None:
    """``torch.a.b(...)`` -> "a.b" (for any alias of torch), else None."""
    d = dotted_name(call.func)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    return rest if head in torch_names and rest else None


def _is_tensor_call(call: ast.Call, torch_names: set[str]) -> bool:
    fn = _torch_fn(call, torch_names)
    if fn is None:
        return False
    return fn.split(".")[0] not in _TORCH_NON_TENSOR


def _host_value(v: ast.AST) -> bool:
    """A value that is a Python object on the host whatever it reads:
    ``int()``/``len()`` of anything, ``.item()``/``.tolist()``/
    ``.numpy()``, a numpy call."""
    if not isinstance(v, ast.Call):
        return False
    f = v.func
    if isinstance(f, ast.Name) and f.id in SYNC_BUILTINS | {"len", "str"}:
        return True
    d = dotted_name(f) or ""
    if d.split(".")[0] in NP_ALIASES:
        return True  # numpy returns host arrays (np.asarray IS the sync)
    return isinstance(f, ast.Attribute) and \
        f.attr in ("item", "tolist", "numpy")


def _tensor_names(fnode, torch_names: set[str],
                  produces=None, payload: bool = False,
                  on_host=None) -> set[str]:
    """Names in ``fnode``'s own body that hold tensors: assigned from a
    tensor-producing ``torch`` call, from a ``produces(call)`` call (an
    entry point or an execution root), from a payload attribute when
    ``payload`` (``rel.mask``), or from an expression over such names —
    but never from static metadata or a value already on the host (what
    an ``on_host(call)`` boundary returns)."""
    out: set[str] = set()
    for _ in range(4):  # tiny fixpoint: assignment chains are short
        before = len(out)
        for n in _walk_own(fnode):
            if isinstance(n, ast.Assign):
                v, tgts = n.value, n.targets
            elif isinstance(n, ast.AnnAssign) and n.value is not None:
                v, tgts = n.value, [n.target]
            elif isinstance(n, ast.AugAssign):
                v, tgts = n.value, [n.target]
            elif isinstance(n, ast.For):
                if _refs(n.iter, out) and not _mentions_static(n.iter):
                    out.update(_target_names(n.target))
                continue
            elif isinstance(n, ast.withitem) and n.optional_vars is not None:
                v, tgts = n.context_expr, [n.optional_vars]
            elif isinstance(n, ast.comprehension):
                if _refs(n.iter, out) and not _mentions_static(n.iter):
                    out.update(_target_names(n.target))
                continue
            else:
                continue
            names = [x for t in tgts for x in _target_names(t)]
            if not names or _host_value(v) or _mentions_static(v) or (
                    on_host is not None and isinstance(v, ast.Call)
                    and on_host(v)):
                continue
            hit = _refs(v, out)
            for c in ast.walk(v):
                if hit:
                    break
                if isinstance(c, ast.Call):
                    hit = _is_tensor_call(c, torch_names) or bool(
                        produces is not None and produces(c))
                elif payload and isinstance(c, ast.Attribute):
                    hit = c.attr in PAYLOAD_ATTRS
            if hit:
                out.update(names)
        if len(out) == before:
            break
    return out


def _walk_own(fnode):
    """Walk a function body WITHOUT descending into nested defs/classes
    (those are separate analysis units; descending double-flags)."""
    stack = list(ast.iter_child_nodes(fnode))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _params(fnode) -> set[str]:
    a = fnode.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs}


def _int_annotated_params(fnode) -> set[str]:
    """Parameters annotated as plain python scalars are host values."""
    out = set()
    args = fnode.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        ann = a.annotation
        s = ast.unparse(ann) if ann is not None else ""
        if s in ("int", "float", "bool", "str",
                 "int | None", "float | None", "bool | None"):
            out.add(a.arg)
    return out


# ---------------------------------------------------------------------------
# flagging
# ---------------------------------------------------------------------------


def _payload(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr in PAYLOAD_ATTRS
               for n in ast.walk(node))


def _kw(call: ast.Call, name: str):
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _is_cpu(node) -> bool:
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and node.args:
        d = dotted_name(node.func) or ""
        return d.endswith("device") and _is_cpu(node.args[0])
    return False


def _upload_site(call: ast.Call, torch_names: set[str]) -> str | None:
    """An upload from pageable host memory: ``torch.from_numpy(a).to(d)``
    without ``non_blocking=True``, ``torch.tensor``/``as_tensor`` with a
    ``device=`` that is not the CPU."""
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr == "to" and \
            isinstance(f.value, ast.Call) and \
            _torch_fn(f.value, torch_names) == "from_numpy":
        nb = _kw(call, "non_blocking")
        if isinstance(nb, ast.Constant) and nb.value:
            return None
        dest = call.args[0] if call.args else _kw(call, "device")
        if dest is None or _is_cpu(dest):
            return None
        return "torch.from_numpy(...).to(...), an upload from pageable memory"
    fn = _torch_fn(call, torch_names)
    if fn in ("tensor", "as_tensor"):
        dest = _kw(call, "device")
        if dest is None or _is_cpu(dest):
            return None
        return f"torch.{fn}(..., device=...), an upload from pageable memory"
    return None


def _data_shape_site(call: ast.Call, torch_names: set[str],
                     method_ok) -> str | None:
    """Ops whose output shape depends on the data -> description."""
    fn = _torch_fn(call, torch_names)
    f = call.func
    if fn is not None:
        name = fn
        args = call.args[1:] if fn == "repeat_interleave" else call.args
    elif isinstance(f, ast.Attribute) and method_ok(f.value) and not (
            isinstance(f.value, ast.Name) and f.value.id in NP_ALIASES):
        name = f.attr
        args = call.args
    else:
        return None
    if name in _DATA_SHAPE_FNS:
        return f"{name}() sizes its output from the data"
    if name == "where" and fn is not None and len(call.args) == 1:
        return "torch.where(cond) sizes its output from the data"
    if name == "repeat_interleave" and _kw(call, "output_size") is None:
        reps = args[0] if args else _kw(call, "repeats")
        if reps is not None and not isinstance(reps, ast.Constant):
            return ("repeat_interleave(tensor repeats) without "
                    "output_size sizes its output from the data")
    return None


def _sync_site(n: ast.Call, evidence, torch_names, always: bool
               ) -> str | None:
    """What of the call ``n`` blocks the host, or None.  ``evidence(expr)``
    says whether an expression holds a tensor; ``always`` (the device
    scope and the host half) flags the torch-only patterns whatever
    their receiver."""
    f = n.func
    d = dotted_name(f)
    if isinstance(f, ast.Name) and f.id in SYNC_BUILTINS and n.args:
        a = n.args[0]
        return f"{f.id}({ast.unparse(a)})" if evidence(a) else None
    if isinstance(f, ast.Attribute) and f.attr in _HOST_METHODS \
            and not n.args:
        v = f.value
        if f.attr == "numpy" and isinstance(v, ast.Call) and \
                isinstance(v.func, ast.Attribute) and \
                v.func.attr in ("cpu", "to"):
            return None  # the copy itself is the sync, flagged there
        torch_only = f.attr in ("cpu", "numpy")
        if (always and torch_only) or evidence(v):
            return f".{f.attr}() on {ast.unparse(v)[:60]}"
        return None
    if isinstance(f, ast.Attribute) and f.attr == "to":
        dest = n.args[0] if n.args else _kw(n, "device")
        if dest is not None and _is_cpu(dest) and \
                (always or evidence(f.value)):
            return f".to(\"cpu\") of {ast.unparse(f.value)[:60]}"
    if d is not None and d.split(".")[0] in NP_ALIASES and \
            d.split(".")[-1] in ("asarray", "array") and n.args:
        a = n.args[0]
        return f"{d}({ast.unparse(a)[:60]})" if evidence(a) else None
    if always and isinstance(f, ast.Attribute) and \
            f.attr == "synchronize":
        return f"{ast.unparse(f)}()"
    fn = _torch_fn(n, torch_names)
    if fn in _TORCH_BOOL_FNS and (always or any(evidence(a)
                                                for a in n.args)):
        return f"torch.{fn}() (a host bool)"
    why = _data_shape_site(
        n, torch_names, (lambda v: True) if always else evidence)
    if why is None and always:
        why = _upload_site(n, torch_names)
    return why


def _sync_finding(info: _FuncInfo, n: ast.Call, what: str,
                  region: str) -> Finding:
    return Finding("trace.host-sync", info.path, n.lineno, info.qual,
                   f"{what}: the host waits on the CUDA stream ({region})")


def _flag_device_scope(info: _FuncInfo, torch_names: set[str],
                       out: list[Finding]) -> None:
    fnode = info.node
    host_params = _int_annotated_params(fnode)
    params = _params(fnode)
    tensors = _tensor_names(fnode, torch_names, payload=True)
    direct = _direct_tensor_names(fnode, torch_names)

    def evidence(a) -> bool:
        if isinstance(a, ast.Constant) or \
                (isinstance(a, ast.Name) and a.id in host_params):
            return False
        if _mentions_static(a):
            return False
        return _refs(a, tensors) or _payload(a) or any(
            isinstance(c, ast.Call) and _is_tensor_call(c, torch_names)
            for c in ast.walk(a))

    def item_evidence(a) -> bool:
        return evidence(a) or (not _mentions_static(a) and _refs(a, params))

    for n in _walk_own(fnode):
        if isinstance(n, ast.Call):
            ev = item_evidence if isinstance(n.func, ast.Attribute) and \
                n.func.attr in ("item", "tolist") else evidence
            what = _sync_site(n, ev, torch_names, True)
            if what is not None:
                out.append(_sync_finding(info, n, what,
                                         "an execution's device scope"))
        elif isinstance(n, (ast.If, ast.While)):
            test = n.test
            if _mentions_static(test):
                continue  # shape/dtype branches are host metadata
            if _branch_reads_tensor(test, direct, torch_names):
                out.append(Finding(
                    "trace.tracer-branch", info.path, n.lineno, info.qual,
                    f"python branch on a tensor "
                    f"({ast.unparse(test)[:60]}) reads it on the host "
                    f"(an implicit bool())"))


def _direct_tensor_names(fnode, torch_names: set[str]) -> set[str]:
    """Names assigned straight from a tensor-producing ``torch`` call —
    the reference's tracer names: a branch test is held to these alone,
    as name reuse across a body would otherwise flag host ints."""
    out: set[str] = set()
    for n in _walk_own(fnode):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                and _is_tensor_call(n.value, torch_names):
            for t in n.targets:
                out.update(_target_names(t))
    return out


def _branch_reads_tensor(test, direct: set[str], torch_names) -> bool:
    """Does evaluating ``test`` as a bool read a tensor's value?  An
    identity test (``x is None``) and a metadata predicate
    (``t.is_floating_point()``) read nothing."""
    if isinstance(test, ast.BoolOp):
        return any(_branch_reads_tensor(v, direct, torch_names)
                   for v in test.values)
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        return _branch_reads_tensor(test.operand, direct, torch_names)
    if isinstance(test, ast.Compare) and all(
            isinstance(o, (ast.Is, ast.IsNot)) for o in test.ops):
        return False
    if isinstance(test, ast.Call) and isinstance(test.func, ast.Attribute) \
            and test.func.attr.startswith("is_"):
        return False
    return _refs(test, direct) or any(
        isinstance(c, ast.Call) and _is_tensor_call(c, torch_names)
        for c in ast.walk(test))


def _flag_host(info: _FuncInfo, torch_names: set[str], produces,
               on_host, half: bool, out: list[Finding]) -> None:
    """A host function: the execution's host half when ``half`` (every
    torch call result is a tensor, every torch-only pattern flagged),
    else plain host code (only the results of executions are tensors)."""
    tn = torch_names if half else set()
    device = _tensor_names(info.node, tn, produces, on_host=on_host)

    def evidence(a) -> bool:
        if _mentions_static(a):
            return False
        return _refs(a, device) or any(
            isinstance(c, ast.Call) and _is_tensor_call(c, tn)
            for c in ast.walk(a))

    region = "an execution's host half" if half else "host code"
    for n in _walk_own(info.node):
        if not isinstance(n, ast.Call):
            continue
        what = _sync_site(n, evidence, torch_names, half)
        if what is not None:
            out.append(_sync_finding(info, n, what, region))


# ---------------------------------------------------------------------------
# cache keys
# ---------------------------------------------------------------------------

_CACHE_DECOS = ("lru_cache", "cache")


def _cached_funcs(idx: _Index) -> set[tuple[str, str]]:
    out = set()
    for key, info in idx.funcs.items():
        for dec in getattr(info.node, "decorator_list", []):
            d = dotted_name(dec if not isinstance(dec, ast.Call)
                            else dec.func)
            if d and d.split(".")[-1] in _CACHE_DECOS:
                out.add(key)
    return out


def _class_hash_eq(cnode: ast.ClassDef) -> tuple[bool, bool]:
    """(has content __hash__, has content __eq__) — frozen dataclasses
    synthesize both."""
    names = {n.name for n in cnode.body
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    frozen = False
    for dec in cnode.decorator_list:
        if isinstance(dec, ast.Call) and \
                (dotted_name(dec.func) or "").endswith("dataclass"):
            for kw in dec.keywords:
                if kw.arg == "frozen" and \
                        isinstance(kw.value, ast.Constant) and kw.value.value:
                    frozen = True
    return ("__hash__" in names or frozen, "__eq__" in names or frozen)


def _flag_cache_keys(idx: _Index, cached: set[tuple[str, str]],
                     out: list[Finding]) -> None:
    all_classes: dict[str, ast.ClassDef] = {}
    for path, cmap in idx.classes.items():
        all_classes.update(cmap)
    for (path, _qual), info in idx.funcs.items():
        for call in info.calls:
            resolved = idx.resolve_call(path, call)
            if not resolved or not any(r in cached for r in resolved):
                continue
            for a in list(call.args) + [kw.value for kw in call.keywords]:
                if isinstance(a, (ast.List, ast.Dict, ast.Set)):
                    out.append(Finding(
                        "trace.cache-key", path, a.lineno, info.qual,
                        f"mutable {type(a).__name__.lower()} literal in a "
                        f"compile-cache key (unhashable or identity-keyed)"))
                elif isinstance(a, ast.Call):
                    d = dotted_name(a.func)
                    if d == "id" or (d or "").endswith(".id"):
                        out.append(Finding(
                            "trace.cache-key", path, a.lineno, info.qual,
                            "id() in a compile-cache key is identity-"
                            "hashed: equal content still retraces"))
                        continue
                    cname = (d or "").split(".")[-1]
                    cnode = all_classes.get(cname)
                    if cnode is not None:
                        has_h, has_e = _class_hash_eq(cnode)
                        if not (has_h and has_e):
                            out.append(Finding(
                                "trace.cache-key", path, a.lineno,
                                info.qual,
                                f"{cname} lacks content __hash__/__eq__ "
                                f"but keys a compile cache: every "
                                f"instance mints a fresh executable"))


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def check_trace_safety(az: Analyzer, roots=None, entries=None,
                       boundaries=None) -> list[Finding]:
    """``roots``/``entries``/``boundaries`` override ``EXECUTION_ROOTS``/
    ``ENTRY_POINTS``/``BOUNDARIES`` (synthetic trees in tests)."""
    roots = EXECUTION_ROOTS if roots is None else roots
    entries = ENTRY_POINTS if entries is None else entries
    boundaries = BOUNDARIES if boundaries is None else boundaries
    idx = _Index(az)
    out: list[Finding] = []
    regs = (("EXECUTION_ROOTS", roots), ("ENTRY_POINTS", entries),
            ("BOUNDARIES", boundaries))
    found = {}
    for name, reg in regs:
        found[name], missing = _registered(idx, reg)
        for path, qual in missing:
            out.append(Finding(
                "trace.unknown-root", path, 1, qual,
                f"{name} names unknown function {qual!r} (renamed or "
                f"removed? the scope would change silently)"))
    scope = _closure(idx, found["EXECUTION_ROOTS"])
    stop = found["BOUNDARIES"]
    half = _closure(idx, found["ENTRY_POINTS"], stop) - scope - stop
    producers = found["EXECUTION_ROOTS"] | found["ENTRY_POINTS"]
    for key, info in idx.funcs.items():
        torch_names = idx.torch_aliases(info.path)

        def produces(call, _p=info.path):
            res = idx.resolve_call(_p, call)
            return bool(res) and all(r in producers for r in res)

        def on_host(call, _p=info.path):
            res = idx.resolve_call(_p, call)
            return bool(res) and all(r in stop for r in res)

        if key in scope:
            _flag_device_scope(info, torch_names, out)
        else:
            _flag_host(info, torch_names, produces, on_host, key in half,
                       out)
    _flag_cache_keys(idx, _cached_funcs(idx), out)
    return out
