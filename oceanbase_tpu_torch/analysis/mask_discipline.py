"""mask-discipline checker: operators must honor the live-row mask
(rules ``mask.*``).

The Static-shape policy (ROADMAP) keeps pad lanes dead in ``mask`` —
every function that reads ``Relation``/``Column`` payload data must
either consume the mask (gate lanes on it) or propagate it to its
output; a function that reads ``.data`` and ignores ``mask`` is exactly
the bug class that turns pad lanes into phantom rows.

The contract is explicit: ``OPERATOR_MODULES`` names the operator
surface, ``CONTRACTS`` registers audited exceptions (helpers whose mask
handling is their caller's documented responsibility).  Rules:

- ``mask.drop``          — reads Relation/Column data, never touches
                           mask, not registered, no pragma;
- ``mask.stale-exempt``  — registered exemption for a function that now
                           handles mask itself (the registry must not
                           rot into a suppression dump);
- ``mask.unknown-exempt``— registry entry naming a function that no
                           longer exists.
"""

from __future__ import annotations

import ast
import fnmatch

from oceanbase_tpu_torch.analysis.core import (
    Analyzer,
    Finding,
    attrs_in,
    dotted_name,
    iter_functions,
)

# the operator surface under contract (glob patterns over repo paths)
OPERATOR_MODULES = (
    "oceanbase_tpu_torch/exec/ops.py",
    "oceanbase_tpu_torch/exec/window.py",
    "oceanbase_tpu_torch/px/*.py",
)

# audited exceptions: qualname (per file) -> why the missing mask touch
# is correct.  These are helpers whose *caller* owns the mask contract —
# the exemption documents the audit, it does not waive review.
CONTRACTS: dict[str, dict[str, str]] = {
    "oceanbase_tpu_torch/exec/ops.py": {
        "_combined_key": "key mixer; callers gate matches via _keys_valid"
                         " which folds the caller's mask",
        "_translate_dict": "code remap on static dictionaries; validity/"
                           "mask stay with the caller's columns",
        "_concat_valid": "validity-lane helper; concat() concatenates the"
                         " masks itself",
        "merge_dicts": "dictionary re-encode (a code remap through a host"
                       " LUT); the callers own the mask: concat() joins the"
                       " masks, window.py's LAG/LEAD default, the session's"
                       " UPDATE and the exchange's all_gather keep theirs",
    },
    "oceanbase_tpu_torch/exec/window.py": {},
    "oceanbase_tpu_torch/px/exchange.py": {
        "_hash_dest": "dest vector; all_to_all_repartition masks dead"
                      " rows to the drop sentinel",
    },
    "oceanbase_tpu_torch/px/range_sort.py": {
        "_primary_scalar": "key scalarizer; dist_sort_shard masks dead"
                           " rows to the drop destination",
    },
    "oceanbase_tpu_torch/px/planner.py": {
        "_row_bytes": "static bytes-per-row estimate from dtype metadata",
        "_keys_hash_partitionable": "plan-time type probe: reads dtypes "
                                    "via eval_expr to pick a dist "
                                    "strategy, emits no row data",
    },
    "oceanbase_tpu_torch/px/dtl.py": {},
    "oceanbase_tpu_torch/px/bloom.py": {
        "_hashes": "returns a NULL-folded validity lane; build/apply "
                   "AND it with the relation mask",
    },
    "oceanbase_tpu_torch/px/dist_ops.py": {},
}

# reading payload: any of these attribute accesses / calls
_DATA_ATTRS = {"data", "valid"}
_DATA_CALLS = {"eval_expr", "eval_predicate"}
# touching the mask contract: any of these
_MASK_ATTRS = {"mask"}
_MASK_CALLS = {"mask_or_true", "with_mask", "filter_rows", "compact"}
_MASK_PARAMS = {"mask", "live", "weight", "m"}


def _reads_data(fnode: ast.AST) -> bool:
    if _DATA_ATTRS & attrs_in(fnode):
        return True
    for n in ast.walk(fnode):
        if isinstance(n, ast.Call):
            d = dotted_name(n.func) or ""
            if d.split(".")[-1] in _DATA_CALLS:
                return True
    return False


def _touches_mask(fnode: ast.AST) -> bool:
    if _MASK_ATTRS & attrs_in(fnode):
        return True
    for n in ast.walk(fnode):
        if isinstance(n, ast.Call):
            d = dotted_name(n.func) or ""
            if d.split(".")[-1] in _MASK_CALLS:
                return True
        if isinstance(n, ast.keyword) and n.arg in _MASK_PARAMS:
            return True
    args = getattr(fnode, "args", None)
    if args is not None:
        params = {a.arg for a in
                  args.posonlyargs + args.args + args.kwonlyargs}
        if params & _MASK_PARAMS:
            return True
    return False


def _operator_files(az: Analyzer) -> list[str]:
    out = []
    for path in az.trees:
        if any(fnmatch.fnmatch(path, pat) for pat in OPERATOR_MODULES):
            out.append(path)
    return sorted(out)


def check_mask_discipline(az: Analyzer) -> list[Finding]:
    out: list[Finding] = []
    for path in _operator_files(az):
        tree = az.trees[path]
        exempt = CONTRACTS.get(path, {})
        seen: set[str] = set()
        for qual, fnode, _cls in iter_functions(tree):
            seen.add(qual)
            reads = _reads_data(fnode)
            touches = _touches_mask(fnode)
            if qual in exempt:
                if not reads or touches:
                    out.append(Finding(
                        "mask.stale-exempt", path, fnode.lineno, qual,
                        f"registry exempts {qual} but it "
                        f"{'does not read data' if not reads else 'already handles mask'}"
                        f" — drop the stale entry"))
                continue
            if reads and not touches:
                out.append(Finding(
                    "mask.drop", path, fnode.lineno, qual,
                    f"{qual} reads Relation/Column data but neither "
                    f"consumes nor propagates mask — pad lanes would "
                    f"leak into results"))
        for name in exempt:
            if name not in seen:
                out.append(Finding(
                    "mask.unknown-exempt", path, 1, name,
                    f"registry exempts unknown function {name}"))
    return out
