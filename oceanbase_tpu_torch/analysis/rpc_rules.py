"""rpc verb/policy coherence checker (rules ``rpc.*``).

The robustness plane's standing contract (the reference's): every wire
verb a node serves has an explicit ``net/rpc.py::POLICIES`` entry
(deadline + idempotency declared up front, not discovered in an
outage), no non-idempotent verb rides a resend loop, and bulk-payload
replies carry a digest field the client can verify.

The checker parses the ``POLICIES`` dict literal straight out of
``net/rpc.py`` (no import — works on synthetic trees too), collects
served verbs from handler-dict literals and ``.register(...)`` calls in
the handler surface, and cross-references:

- ``rpc.missing-policy``       — a served verb with no ``POLICIES``
                                 entry rides ``DEFAULT_POLICY`` blind
                                 (flagged at the registration site);
- ``rpc.nonidempotent-resend`` — a ``.call(...)`` of a non-idempotent
                                 (or unknown) verb inside a retry loop
                                 that swallows transport errors — the
                                 classic double-apply window;
- ``rpc.bulk-no-digest``       — a handler reply dict shipping a bulk
                                 payload key with no sibling crc/digest
                                 field (the wire twin of
                                 ``io.unverified-write``).
"""

from __future__ import annotations

import ast
import fnmatch
import re

from oceanbase_tpu_torch.analysis.core import Analyzer, Finding
from oceanbase_tpu_torch.analysis.trace_safety import _Index

#: where POLICIES lives
POLICY_FILE = "oceanbase_tpu_torch/net/rpc.py"

#: files whose dict literals / register() calls serve wire verbs
HANDLER_GLOBS = (
    "oceanbase_tpu_torch/net/*.py",
    "oceanbase_tpu_torch/palf/*.py",
)

#: where non-idempotent-resend discipline applies (client call sites)
RESEND_SCOPE = (
    "oceanbase_tpu_torch/net/*.py",
    "oceanbase_tpu_torch/palf/*.py",
    "oceanbase_tpu_torch/px/*.py",
    "oceanbase_tpu_torch/exec/*.py",
    "oceanbase_tpu_torch/storage/*.py",
    "oceanbase_tpu_torch/server/*.py",
)

#: reply keys that mean "bulk payload" (rows, chunk bytes, manifests)
BULK_KEYS = {"data", "arrays", "manifest", "slog", "payload"}

#: sibling key substrings that count as a digest field
_DIGESTISH = ("crc", "digest", "checksum")

_VERB_RE = re.compile(r"^[a-z_]+\.[a-z_]+$")


def _globbed(az: Analyzer, pats) -> list[str]:
    return [p for p in az.trees
            if any(fnmatch.fnmatch(p, pat) for pat in pats)]


def _parse_policies(az: Analyzer) -> dict[str, bool] | None:
    """verb -> idempotent? from the POLICIES dict literal, or None when
    the policy file isn't in the analyzed set (synthetic trees)."""
    tree = az.trees.get(POLICY_FILE)
    if tree is None:
        return None
    policies: dict[str, bool] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign):  # POLICIES: dict[...] = {..}
            targets = [node.target]
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == "POLICIES"
                   for t in targets):
            continue
        if not isinstance(node.value, ast.Dict):
            continue
        for k, v in zip(node.value.keys, node.value.values):
            if not (isinstance(k, ast.Constant) and
                    isinstance(k.value, str)):
                continue
            idem = False
            if isinstance(v, ast.Call):
                if len(v.args) >= 2 and \
                        isinstance(v.args[1], ast.Constant):
                    idem = bool(v.args[1].value)
                for kw in v.keywords:
                    if kw.arg == "idempotent" and \
                            isinstance(kw.value, ast.Constant):
                        idem = bool(kw.value.value)
            policies[k.value] = idem
    return policies


def _looks_like_verb(s: str) -> bool:
    return s == "ping" or bool(_VERB_RE.match(s))


def _served_verbs(az: Analyzer) -> list[tuple[str, int, str]]:
    """(verb, lineno, path) for every registration site: dict literals
    mapping verb strings to handler callables (not Constants, not
    ``VerbPolicy(...)``-style Calls — that shape is POLICIES itself),
    plus ``.register("verb", fn)`` calls."""
    out: list[tuple[str, int, str]] = []
    for path in _globbed(az, HANDLER_GLOBS):
        for node in ast.walk(az.trees[path]):
            if isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if not (isinstance(k, ast.Constant) and
                            isinstance(k.value, str) and
                            _looks_like_verb(k.value)):
                        continue
                    if isinstance(v, (ast.Constant, ast.Call)):
                        continue
                    out.append((k.value, k.lineno, path))
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "register" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) and \
                    _looks_like_verb(node.args[0].value):
                out.append((node.args[0].value, node.lineno, path))
    return out


def _call_verb(call: ast.Call) -> str | None:
    f = call.func
    if not (isinstance(f, ast.Attribute) and
            f.attr in ("call", "call_with_size")):
        return None
    if call.args and isinstance(call.args[0], ast.Constant) and \
            isinstance(call.args[0].value, str) and \
            _looks_like_verb(call.args[0].value):
        return call.args[0].value
    return None


def _swallowing_try(try_node: ast.Try) -> bool:
    """At least one except handler does not end by re-raising — the
    error is absorbed and the loop comes back around."""
    for h in try_node.handlers:
        if not h.body or not isinstance(h.body[-1], ast.Raise):
            return True
    return False


def _resend_sites(fnode: ast.AST) -> list[ast.Call]:
    """``.call(verb, ...)`` sites lexically inside a loop AND inside a
    try whose except swallows — the resend-ladder shape."""
    out: list[ast.Call] = []

    def visit(node, in_loop, in_swallow):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            loop = in_loop or isinstance(child, (ast.For, ast.While))
            swallow = in_swallow or (isinstance(child, ast.Try) and
                                     _swallowing_try(child))
            if loop and swallow and isinstance(child, ast.Call) and \
                    _call_verb(child) is not None:
                out.append(child)
            visit(child, loop, swallow)

    visit(fnode, False, False)
    return out


def _dict_returns(fnode: ast.AST) -> list[ast.Dict]:
    out = []
    for n in ast.walk(fnode):
        if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict):
            out.append(n.value)
    return out


def _dict_keys(d: ast.Dict) -> list[str]:
    return [k.value for k in d.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, str)]


def check_rpc_rules(az: Analyzer) -> list[Finding]:
    policies = _parse_policies(az)
    idx = _Index(az)
    out: list[Finding] = []

    # rpc.missing-policy — every served verb declared up front
    if policies is not None:
        seen: set[tuple[str, str, int]] = set()
        for verb, lineno, path in _served_verbs(az):
            if verb in policies:
                continue
            key = (verb, path, lineno)
            if key in seen:
                continue
            seen.add(key)
            out.append(Finding(
                "rpc.missing-policy", path, lineno, None,
                f"served verb {verb!r} has no net/rpc.py POLICIES "
                f"entry — it rides DEFAULT_POLICY with an undeclared "
                f"deadline and idempotency"))

    # rpc.nonidempotent-resend — client-side double-apply windows
    for path in _globbed(az, RESEND_SCOPE):
        for (p, qual), info in idx.funcs.items():
            if p != path:
                continue
            for call in _resend_sites(info.node):
                verb = _call_verb(call)
                idem = (policies or {}).get(verb, False)
                if idem:
                    continue
                known = policies is not None and verb in policies
                out.append(Finding(
                    "rpc.nonidempotent-resend", p, call.lineno, qual,
                    f"{'non-idempotent' if known else 'unknown-policy'} "
                    f"verb {verb!r} called from an error-swallowing "
                    f"retry loop: a transport error after the request "
                    f"hit the wire re-applies the side effect"))

    # rpc.bulk-no-digest — handler replies ship verifiable payloads
    bulk_files = set(_globbed(az, HANDLER_GLOBS))
    if "oceanbase_tpu_torch/px/dtl.py" in az.trees:
        bulk_files.add("oceanbase_tpu_torch/px/dtl.py")
    for path in sorted(bulk_files):
        for (p, qual), info in idx.funcs.items():
            if p != path:
                continue
            for d in _dict_returns(info.node):
                keys = _dict_keys(d)
                bulk = [k for k in keys if k in BULK_KEYS]
                if not bulk:
                    continue
                if any(any(t in k.lower() for t in _DIGESTISH)
                       for k in keys):
                    continue
                out.append(Finding(
                    "rpc.bulk-no-digest", p, d.lineno, qual,
                    f"reply ships bulk payload {bulk[0]!r} with no "
                    f"crc/digest sibling field — the peer cannot "
                    f"verify what it received (see dtl.verify_reply)"))
    return out
