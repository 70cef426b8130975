"""cancel-discipline checker: long host loops observe checkpoints
(rules ``cancel.*``).

The overload-safety plane's standing contract (the reference's): every
host-side loop that can block — chunk iteration over the wire, peer
fan-out polling, retry ladders, bulk file copies — must reach
``server/admission.py::checkpoint()`` (or a registered equivalent) in
its body's call closure, so a KILL / statement deadline / shutdown is
observed within one iteration instead of after the whole transfer.

Detection is trigger-based: a loop is *blocking* when its body's
transitive call closure contains an RPC round-trip (``.call``/
``.call_with_size``/``.ping``), a ``time.sleep``, a ``shutil`` bulk
copy, or a subprocess — and *observing* when the same closure reaches
the admission checkpoint, a ``StmtCtx.check()``, a stop/cancel-named
event wait, or a ``CHECKPOINT_EQUIV`` registrant.  Pure-CPU loops are
out of scope (the statement-path result-boundary checkpoints own them).

Rules:

- ``cancel.loop-no-checkpoint``     — blocking loop with no observation
                                      point in its closure;
- ``cancel.fanout-no-propagation``  — RPC fan-out (threads spawned in a
                                      loop/comprehension whose target
                                      closure does RPC) with no
                                      cancellation-propagation path
                                      (the ``dtl.cancel`` pattern) and
                                      no stop-event plumbing;
- ``cancel.unknown-exempt`` / ``cancel.stale-exempt`` — registry
  hygiene for ``CANCEL_EXEMPT`` (mirrors mask_discipline.CONTRACTS).
"""

from __future__ import annotations

import ast
import fnmatch

from oceanbase_tpu_torch.analysis.core import (
    Analyzer,
    Finding,
    dotted_name,
)
from oceanbase_tpu_torch.analysis.trace_safety import _Index

#: the blocking-loop surface under contract
CANCEL_SCOPE = (
    "oceanbase_tpu_torch/exec/*.py",
    "oceanbase_tpu_torch/px/*.py",
    "oceanbase_tpu_torch/net/*.py",
    "oceanbase_tpu_torch/storage/scrub.py",
    "oceanbase_tpu_torch/server/backup.py",
)

ADMISSION_MODULE = "oceanbase_tpu_torch.server.admission"

#: audited exceptions: qualname (per file) -> why the loop may block
#: without an admission checkpoint.  Function-level; single loop sites
#: prefer an inline ``# obcheck: ok(cancel.loop-no-checkpoint)``.
CANCEL_EXEMPT: dict[str, dict[str, str]] = {
    "oceanbase_tpu_torch/net/rpc.py": {
        "RpcClient._call_loop":
            "the retry engine itself: every attempt re-checks the verb"
            " policy's end-to-end deadline, and the statement-level"
            " checkpoint discipline sits at the call sites above it",
    },
}

#: functions that COUNT as a checkpoint observation when reached from a
#: loop body's closure — (path, qualname); audited like CANCEL_EXEMPT
CHECKPOINT_EQUIV: set[tuple[str, str]] = set()

#: audited one-shot initializers whose bodies are NOT scanned for
#: blocking triggers: (path, qualname) -> why.  native._load runs
#: ``make`` exactly once per process (guarded by _build_attempted), so
#: the crc64 fast path that every digest loop rides is not a per-
#: iteration block.
CANCEL_NONBLOCKING: dict[tuple[str, str], str] = {
    ("oceanbase_tpu_torch/native.py", "_load"):
        "lazy one-time native build: the subprocess runs at most once "
        "per process, after which the ctypes fast path is pure CPU",
}

#: receiver names whose .wait()/.is_set() is a cancellation observation
_STOPPISH = ("stop", "cancel", "kill", "shutdown", "quit")

_RPC_ATTRS = {"call", "call_with_size", "ping"}
_SUBPROCESS_FNS = {"run", "check_call", "check_output", "Popen", "call"}


def _scope_files(az: Analyzer) -> list[str]:
    return [p for p in az.trees
            if any(fnmatch.fnmatch(p, pat) for pat in CANCEL_SCOPE)]


def _is_blocking_call(call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Attribute) and f.attr in _RPC_ATTRS:
        d = dotted_name(f) or ""
        root = d.split(".")[0]
        if root in ("time", "os", "json", "struct"):
            return False  # stdlib namesakes, not an RpcClient
        return True
    d = dotted_name(f) or ""
    if d == "time.sleep":
        return True
    parts = d.split(".")
    if parts[0] == "shutil" and \
            parts[-1].startswith(("copy", "move")):
        return True
    if parts[0] == "subprocess" and parts[-1] in _SUBPROCESS_FNS:
        return True
    return False


def _imported_module(idx: _Index, path: str, name: str) -> str | None:
    """The full module a bare name refers to (``import m as name`` or
    ``from pkg import mod as name``), else None."""
    mod = idx.alias[path].get(name)
    if mod is not None:
        return mod
    imp = idx.from_imp[path].get(name)
    if imp is not None:
        return f"{imp[0]}.{imp[1]}"
    return None


def _is_checkpoint_call(idx: _Index, path: str, call: ast.Call) -> bool:
    f = call.func
    if isinstance(f, ast.Name):
        if f.id != "checkpoint":
            return False
        imp = idx.from_imp[path].get("checkpoint")
        return imp is not None and imp[0] == ADMISSION_MODULE
    if isinstance(f, ast.Attribute) and f.attr == "checkpoint" and \
            isinstance(f.value, ast.Name):
        # qadmission.checkpoint() — NOT tenant.checkpoint() (the storage
        # replay-point flush shares the name); resolve via import maps
        return _imported_module(idx, path, f.value.id) == ADMISSION_MODULE
    return False


def _is_observation_call(idx: _Index, path: str, call: ast.Call) -> bool:
    if _is_checkpoint_call(idx, path, call):
        return True
    f = call.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "check" and not call.args:
        recv = dotted_name(f.value) or ""
        last = recv.split(".")[-1].lower()
        return "ctx" in last or "stmt" in last
    if f.attr in ("wait", "is_set"):
        recv = (dotted_name(f.value) or "").lower()
        return any(s in recv for s in _STOPPISH)
    return False


def _resolve(idx: _Index, path: str, call: ast.Call
             ) -> list[tuple[str, str]]:
    out = idx.resolve_call(path, call)
    if out:
        return out
    f = call.func
    if isinstance(f, ast.Attribute):
        cands = [q for q in idx.by_name[path].get(f.attr, []) if "." in q]
        if 0 < len(cands) <= 2:
            return [(path, q) for q in cands]
    return []


def _walk_no_defs(node: ast.AST):
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _loop_scan(idx: _Index, path: str, loop: ast.AST
               ) -> tuple[bool, bool]:
    """(blocks, observes) over the loop's body closure: direct calls in
    the loop subtree plus the bodies of every package function they
    transitively reach."""
    calls = [n for n in _walk_no_defs(loop) if isinstance(n, ast.Call)]
    if isinstance(loop, ast.While):  # `while not stop.wait(t):`
        calls += [n for n in ast.walk(loop.test)
                  if isinstance(n, ast.Call)]
    blocks = observes = False
    seen: set[tuple[str, str]] = set()
    work: list[tuple[str, list[ast.Call]]] = [(path, calls)]
    while work and not (blocks and observes):
        p, cs = work.pop()
        for c in cs:
            if _is_blocking_call(c):
                blocks = True
            if _is_observation_call(idx, p, c):
                observes = True
            for tgt in _resolve(idx, p, c):
                if tgt in seen:
                    continue
                seen.add(tgt)
                if tgt in CHECKPOINT_EQUIV:
                    observes = True
                if tgt in CANCEL_NONBLOCKING:
                    continue
                info = idx.funcs.get(tgt)
                if info is not None:
                    work.append((info.path, info.calls))
    return blocks, observes


def _top_level_loops(fnode: ast.AST):
    """Outermost for/while loops of a function body (a checkpointed
    outer loop bounds its inner retry ladders per iteration).  A ``for``
    over a literal tuple/list is bounded by the source text (O(1)
    iterations) — skipped, but its body may still hold real loops."""
    stack = list(ast.iter_child_nodes(fnode))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            continue
        if isinstance(n, ast.For) and \
                isinstance(n.iter, (ast.Tuple, ast.List)):
            stack.extend(n.body)
            continue
        if isinstance(n, (ast.For, ast.While)):
            yield n
            continue
        stack.extend(ast.iter_child_nodes(n))


def _thread_fanouts(fnode: ast.AST) -> list[tuple[ast.Call, str]]:
    """(call, target_name) for Thread(target=X)/submit(X) sites that sit
    inside a loop or comprehension — a fan-out, not a lone daemon."""
    out: list[tuple[ast.Call, str]] = []

    def visit(node, in_loop):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            here = in_loop or isinstance(
                child, (ast.For, ast.While, ast.ListComp, ast.SetComp,
                        ast.GeneratorExp))
            if here and isinstance(child, ast.Call):
                d = dotted_name(child.func) or ""
                tgt = None
                if d.split(".")[-1] == "Thread":
                    for kw in child.keywords:
                        if kw.arg == "target" and \
                                isinstance(kw.value, ast.Name):
                            tgt = kw.value.id
                elif isinstance(child.func, ast.Attribute) and \
                        child.func.attr == "submit" and child.args and \
                        isinstance(child.args[0], ast.Name):
                    tgt = child.args[0].id
                if tgt is not None:
                    out.append((child, tgt))
            visit(child, here)

    visit(fnode, False)
    return out


def _closure_blocks_rpc(idx: _Index, root: tuple[str, str]) -> bool:
    seen = {root}
    work = [root]
    while work:
        info = idx.funcs.get(work.pop())
        if info is None:
            continue
        for c in info.calls:
            f = c.func
            if isinstance(f, ast.Attribute) and f.attr in _RPC_ATTRS:
                return True
            for tgt in _resolve(idx, info.path, c):
                if tgt not in seen:
                    seen.add(tgt)
                    work.append(tgt)
    return False


def _has_cancel_path(fnode: ast.AST) -> bool:
    """A cancellation-propagation path in the spawning function: a
    cancel-verb string constant anywhere in its closure-visible body
    (``cli.call("dtl.cancel", ...)``) or stop/cancel event plumbing."""
    for n in ast.walk(fnode):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) and \
                "cancel" in n.value:
            return True
        if isinstance(n, (ast.Name, ast.Attribute)):
            s = (n.id if isinstance(n, ast.Name) else n.attr).lower()
            if any(t in s for t in _STOPPISH):
                return True
    return False


def check_cancel_rules(az: Analyzer,
                       exempt: dict[str, dict[str, str]] | None = None
                       ) -> list[Finding]:
    exempt = CANCEL_EXEMPT if exempt is None else exempt
    idx = _Index(az)
    out: list[Finding] = []
    flagged_exempt: set[tuple[str, str]] = set()  # exempt fns that NEED it
    for path in _scope_files(az):
        for (p, qual), info in idx.funcs.items():
            if p != path:
                continue
            exempted = qual in exempt.get(p, {})
            for loop in _top_level_loops(info.node):
                blocks, observes = _loop_scan(idx, p, loop)
                if not blocks or observes:
                    continue
                if exempted:
                    flagged_exempt.add((p, qual))
                    continue
                out.append(Finding(
                    "cancel.loop-no-checkpoint", p, loop.lineno, qual,
                    "blocking loop (rpc/sleep/bulk-copy in its call "
                    "closure) never reaches admission.checkpoint(); a "
                    "KILL or statement deadline waits out the whole "
                    "transfer"))
            for call, tgt in _thread_fanouts(info.node):
                targets = [(p, q) for q in idx.by_name[p].get(tgt, [])]
                if not any(_closure_blocks_rpc(idx, t) for t in targets):
                    continue
                if _has_cancel_path(info.node):
                    continue
                out.append(Finding(
                    "cancel.fanout-no-propagation", p, call.lineno, qual,
                    f"RPC fan-out thread target {tgt!r} has no "
                    f"cancellation-propagation path (no cancel verb, no "
                    f"stop event) — in-flight remote work outlives a "
                    f"kill; see the dtl.cancel pattern"))
    # registry hygiene
    for path, entries in sorted(exempt.items()):
        if path not in az.trees:
            continue
        for qual in sorted(entries):
            key = (path, qual)
            if key not in idx.funcs:
                out.append(Finding(
                    "cancel.unknown-exempt", path, 1, qual,
                    f"CANCEL_EXEMPT names unknown function {qual!r} "
                    f"(renamed or removed? prune the entry)"))
            elif key not in flagged_exempt:
                out.append(Finding(
                    "cancel.stale-exempt", path,
                    idx.funcs[key].node.lineno, qual,
                    f"stale CANCEL_EXEMPT entry: {qual!r} has no "
                    f"unobserved blocking loop anymore (prune it)"))
    return out
