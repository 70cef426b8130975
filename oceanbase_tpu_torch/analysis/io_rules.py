"""io-discipline checker: durable binary writes carry checksums
(rules ``io.*``).

The integrity plane's standing contract (the reference's): every NEW
persistence boundary ships bytes with a crc64-family digest computed at
write time and re-verified on load.  The enforcement is reachability,
not ceremony: a function that opens a file in a binary *create* mode
(``"wb"``/``"xb"``) inside the durable surface (``storage/``,
``palf/``, ``net/``, ``server/``) must reach one of the
``storage/integrity.py`` digest helpers (``crc64``/``bytes_crc``/
``arrays_crc``/``chunk_crc``/``table_digest``) in its transitive call
closure — computing the digest it writes, or verifying the bytes it is
about to install (the rebuild/scrub staging pattern).

Transient-by-design artifacts (spill chunks, TLS PEMs whose loader is
the verifier) live in the audited ``IO_EXEMPT`` registry.  Rules:

- ``io.unverified-write``        — binary create-mode write with no
                                   digest helper in the writer's call
                                   closure, not registered, no pragma;
- ``io.inplace-durable-write``   — a create-mode ``open`` (binary OR
                                   text) in the durable surface that
                                   writes its final path directly: a
                                   crash mid-write leaves a TORN
                                   current-generation artifact.  The
                                   discipline is stage-then-publish —
                                   write a ``*.tmp`` sibling and
                                   ``os.replace`` it over the real name
                                   (append-mode writes are exempt: the
                                   unwind protocol truncates them back).
                                   Verified-staging writers live in the
                                   audited ``INPLACE_EXEMPT`` registry;
- ``io.unregistered-exemption``  — registry hygiene: an ``IO_EXEMPT``/
                                   ``INPLACE_EXEMPT`` entry naming a
                                   function that no longer exists
                                   (unknown) or one whose writes no
                                   longer trip the rule (stale) — the
                                   registries must not rot into
                                   suppression dumps.
"""

from __future__ import annotations

import ast
import fnmatch

from oceanbase_tpu_torch.analysis.core import (
    Analyzer,
    Finding,
    dotted_name,
)
from oceanbase_tpu_torch.analysis.trace_safety import _Index, _walk_own

#: the durable surface under contract (glob patterns over repo paths)
IO_SCOPE = (
    "oceanbase_tpu_torch/storage/*.py",
    "oceanbase_tpu_torch/palf/*.py",
    "oceanbase_tpu_torch/net/*.py",
    "oceanbase_tpu_torch/server/*.py",
)

#: storage/integrity.py digest helpers (plus the native crc64 they wrap)
DIGEST_HELPERS = {"crc64", "bytes_crc", "arrays_crc", "chunk_crc",
                  "table_digest"}

#: binary create modes under contract ("ab" appends ride an existing
#: format whose entries self-verify; text modes are config/docs)
WRITE_MODES = {"wb", "xb", "wb+", "xb+", "w+b", "x+b"}

#: every create mode (binary + text) — the in-place rule covers both:
#: a torn manifest.json is as fatal as a torn segment
CREATE_MODES = WRITE_MODES | {"w", "x", "w+", "x+", "wt", "xt"}

#: audited transient-by-design writers: path -> qualname -> why the
#: missing digest is correct.  The exemption documents the audit, it
#: does not waive review.
IO_EXEMPT: dict[str, dict[str, str]] = {
    "oceanbase_tpu_torch/storage/tmpfile.py": {
        "TempFileStore.append_chunk":
            "spill chunks are transient per-statement artifacts: a torn"
            " or rotten chunk fails the statement on read-back"
            " (np.load raises), never durability",
    },
    "oceanbase_tpu_torch/server/tls.py": {
        "ensure_server_credentials":
            "self-signed PEM pair: ssl.load_cert_chain is the"
            " verify-on-load (a corrupt PEM fails loudly at server"
            " start) and the pair is regenerated, not repaired",
    },
}

#: audited direct-path writers for io.inplace-durable-write: functions
#: whose create-mode writes are safe WITHOUT tmp+rename because the
#: destination is itself a staging/ephemeral artifact or is verified
#: before install.  path -> qualname -> why.
INPLACE_EXEMPT: dict[str, dict[str, str]] = {
    "oceanbase_tpu_torch/storage/scrub.py": {
        "Scrubber._repair_from_peer":
            "writes the fetched manifest into the .scrub_tmp staging"
            " dir, which is rmtree'd and rebuilt per attempt; segments"
            " install from staging only after digest verification",
    },
    "oceanbase_tpu_torch/net/rebuild.py": {
        "fetch_file":
            "rebuild/scrub staging download: every chunk is"
            " crc-verified before the write and the whole file against"
            " the peer digest after assembly — a torn dst is re-fetched"
            " wholesale, never trusted",
    },
    "oceanbase_tpu_torch/server/tls.py": {
        "ensure_server_credentials":
            "self-signed PEM pair regenerated on any load failure:"
            " ssl.load_cert_chain verifies at server start and a torn"
            " PEM is replaced, not repaired",
    },
}


def _scope_files(az: Analyzer) -> list[str]:
    return [p for p in az.trees
            if any(fnmatch.fnmatch(p, pat) for pat in IO_SCOPE)]


def _write_mode(call: ast.Call) -> str | None:
    """The binary create mode of an ``open``/``os.fdopen`` call, else
    None."""
    d = dotted_name(call.func)
    if d not in ("open", "os.fdopen"):
        return None
    mode_node = call.args[1] if len(call.args) >= 2 else None
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if isinstance(mode_node, ast.Constant) and \
            isinstance(mode_node.value, str) and \
            mode_node.value in WRITE_MODES:
        return mode_node.value
    return None


def _create_mode(call: ast.Call) -> str | None:
    """The create mode (binary or text) of an ``open``/``os.fdopen``
    call, else None."""
    d = dotted_name(call.func)
    if d not in ("open", "os.fdopen"):
        return None
    mode_node = call.args[1] if len(call.args) >= 2 else None
    for kw in call.keywords:
        if kw.arg == "mode":
            mode_node = kw.value
    if isinstance(mode_node, ast.Constant) and \
            isinstance(mode_node.value, str) and \
            mode_node.value in CREATE_MODES:
        return mode_node.value
    return None


def _path_is_staged(call: ast.Call) -> bool:
    """True when the open's path expression visibly names a staging
    artifact: a ``*.tmp``-suffixed string, or a variable/attribute
    whose name contains ``tmp`` (``tmp``, ``tmp_path``, ``state_tmp``).
    Under-detection only ever over-reports into the audited registry,
    never silently passes a direct write."""
    node = call.args[0] if call.args else None
    if node is None:
        return False
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                and "tmp" in n.value.lower():
            return True
        if isinstance(n, ast.Name) and "tmp" in n.id.lower():
            return True
        if isinstance(n, ast.Attribute) and "tmp" in n.attr.lower():
            return True
    return False


def _publishes_by_rename(fnode: ast.AST) -> bool:
    """Does this function (own statements only) call os.replace /
    os.rename — i.e. stage-then-publish within the same frame?"""
    for n in _walk_own(fnode):
        if isinstance(n, ast.Call) and \
                dotted_name(n.func) in ("os.replace", "os.rename"):
            return True
    return False


def _resolve_with_methods(idx: _Index, path: str, call: ast.Call
                          ) -> list[tuple[str, str]]:
    """``_Index.resolve_call`` plus a file-local unique-method fallback:
    an attribute call on an unresolvable receiver (``e.encode()``)
    resolves to same-file methods of that name when the name is close to
    unique (≤2 candidates) — the lock_order heuristic.  Under-resolution
    only ever under-reports; the fallback keeps single-class files like
    palf/log.py (LogEntry.encode embeds the crc) honest."""
    out = idx.resolve_call(path, call)
    if out:
        return out
    f = call.func
    if isinstance(f, ast.Attribute):
        cands = [q for q in idx.by_name[path].get(f.attr, []) if "." in q]
        if 0 < len(cands) <= 2:
            return [(path, q) for q in cands]
    return []


def _closure(idx: _Index, root: tuple[str, str]) -> set[tuple[str, str]]:
    """Transitive call closure of one function (with the unique-method
    fallback), bounded by the package file set."""
    scope = {root}
    work = [root]
    while work:
        key = work.pop()
        info = idx.funcs.get(key)
        if info is None:
            continue
        for call in info.calls:
            for tgt in _resolve_with_methods(idx, info.path, call):
                if tgt not in scope:
                    scope.add(tgt)
                    work.append(tgt)
    return scope


def _mentions_digest(fnode: ast.AST) -> bool:
    for n in ast.walk(fnode):
        if isinstance(n, ast.Call):
            d = dotted_name(n.func) or ""
            if d.split(".")[-1] in DIGEST_HELPERS:
                return True
    return False


def _digest_protected(idx: _Index, key: tuple[str, str]) -> bool:
    for tgt in _closure(idx, key):
        info = idx.funcs.get(tgt)
        if info is not None and _mentions_digest(info.node):
            return True
    return False


def _binary_writes(info) -> list[tuple[ast.Call, str]]:
    # own-walk: a nested def's writes belong to its own _FuncInfo
    return [(n, m) for n in _walk_own(info.node)
            if isinstance(n, ast.Call) and (m := _write_mode(n))]


def check_io_rules(az: Analyzer,
                   exempt: dict[str, dict[str, str]] | None = None,
                   inplace_exempt: dict[str, dict[str, str]] | None = None
                   ) -> list[Finding]:
    exempt = IO_EXEMPT if exempt is None else exempt
    inplace_exempt = (INPLACE_EXEMPT if inplace_exempt is None
                      else inplace_exempt)
    idx = _Index(az)
    out: list[Finding] = []
    writers: dict[tuple[str, str], bool] = {}  # key -> protected?
    #: key -> has at least one direct-path create write (pre-exemption)
    inplace_writers: dict[tuple[str, str], bool] = {}
    for path in _scope_files(az):
        for (p, qual), info in idx.funcs.items():
            if p != path:
                continue
            creates = [(n, m) for n in _walk_own(info.node)
                       if isinstance(n, ast.Call)
                       and (m := _create_mode(n))]
            if creates:
                renames = _publishes_by_rename(info.node)
                direct = [(c, m) for c, m in creates
                          if not renames and not _path_is_staged(c)]
                inplace_writers[(p, qual)] = bool(direct)
                if qual not in inplace_exempt.get(p, {}):
                    for call, mode in direct:
                        out.append(Finding(
                            "io.inplace-durable-write", p, call.lineno,
                            qual,
                            f'create-mode write (mode "{mode}") lands '
                            f'on its final path: a crash mid-write '
                            f'tears the current generation — stage a '
                            f'*.tmp sibling and os.replace it, or '
                            f'register in io_rules.INPLACE_EXEMPT'))
            writes = _binary_writes(info)
            if not writes:
                continue
            protected = _digest_protected(idx, (p, qual))
            writers[(p, qual)] = protected
            if protected or qual in exempt.get(p, {}):
                continue
            for call, mode in writes:
                out.append(Finding(
                    "io.unverified-write", p, call.lineno, qual,
                    f'binary write (mode "{mode}") lacks a reachable '
                    f'storage/integrity digest (crc on write or '
                    f'verify-on-load); route through integrity helpers '
                    f'or register in io_rules.IO_EXEMPT'))
    # registry hygiene (only for paths present in the analyzed set, so
    # synthetic test trees never trip over the real repo's entries)
    for path, entries in sorted(exempt.items()):
        if path not in az.trees:
            continue
        for qual in sorted(entries):
            key = (path, qual)
            if key not in idx.funcs:
                out.append(Finding(
                    "io.unregistered-exemption", path, 1, qual,
                    f"IO_EXEMPT names unknown function {qual!r} "
                    f"(renamed or removed? prune the entry)"))
            elif key not in writers or writers[key]:
                out.append(Finding(
                    "io.unregistered-exemption", path,
                    idx.funcs[key].node.lineno, qual,
                    f"stale IO_EXEMPT entry: {qual!r} has no "
                    f"unverified binary write anymore (prune it)"))
    for path, entries in sorted(inplace_exempt.items()):
        if path not in az.trees:
            continue
        for qual in sorted(entries):
            key = (path, qual)
            if key not in idx.funcs:
                out.append(Finding(
                    "io.unregistered-exemption", path, 1, qual,
                    f"INPLACE_EXEMPT names unknown function {qual!r} "
                    f"(renamed or removed? prune the entry)"))
            elif not inplace_writers.get(key, False):
                out.append(Finding(
                    "io.unregistered-exemption", path,
                    idx.funcs[key].node.lineno, qual,
                    f"stale INPLACE_EXEMPT entry: {qual!r} has no "
                    f"direct-path create write anymore (prune it)"))
    return out
