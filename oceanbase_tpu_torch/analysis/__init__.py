"""obcheck over the port: static analysis holding ``oceanbase_tpu_torch``
to its contracts.

Port of ``oceanbase_tpu/analysis``.  The port's contracts are the
reference's (ROADMAP, "Port contracts"): one host sync per plan
execution, a masked-dead pad lane never influences a result, a lock
order, crc-verified durable writes, cancel checkpoints in blocking
loops, monotonic clocks for elapsed time, declared metric names and rpc
verb policies.  Eight AST checkers, one per rule family, plus one
dynamic verifier:

- ``trace_safety``     — host syncs inside an execution, tensor
                         branches, identity-hashed cache keys (rules
                         ``trace.*``; rewritten for eager torch, see its
                         docstring);
- ``mask_discipline``  — every operator that reads Relation/Column data
                         consumes or propagates ``mask`` (``mask.*``);
- ``lock_order``       — lock-acquisition inversions and shared-dict
                         mutation outside any held lock (``lock.*``);
- ``metric_rules``     — no metric update inside an execution's device
                         scope, every series name a declared literal
                         (``metric.*``);
- ``time_rules``       — no wall-clock elapsed time (``time.*``);
- ``io_rules``         — durable binary writes reach a digest and are
                         staged then published (``io.*``);
- ``cancel_rules``     — blocking host loops reach a cancel checkpoint
                         (``cancel.*``);
- ``rpc_rules``        — wire verbs have declared policies (``rpc.*``);
- ``poison``           — the executable half: fill pad lanes with
                         NaN/sentinel garbage on the device and assert
                         bit-identical results (imports torch; the
                         checkers are pure stdlib).

Audited exceptions carry a ``# obcheck: ok(<rule>)`` pragma (a pragma
covers its own line and the next); everything else diffs against the
checked-in baseline (``analysis/baseline.json``) so only NEW violations
fail.  Driver: ``scripts/torch_obcheck.py``.
"""

from oceanbase_tpu_torch.analysis.core import (
    Analyzer,
    Finding,
    diff_findings,
    load_baseline,
    load_package_files,
    run_all,
    run_all_marked,
    write_baseline,
)
from oceanbase_tpu_torch.analysis.lock_order import check_lock_order
from oceanbase_tpu_torch.analysis.mask_discipline import (
    check_mask_discipline,
)
from oceanbase_tpu_torch.analysis.metric_rules import check_metric_rules
from oceanbase_tpu_torch.analysis.trace_safety import check_trace_safety

__all__ = [
    "Analyzer",
    "Finding",
    "check_lock_order",
    "check_mask_discipline",
    "check_metric_rules",
    "check_trace_safety",
    "diff_findings",
    "load_baseline",
    "load_package_files",
    "run_all",
    "run_all_marked",
    "write_baseline",
]
