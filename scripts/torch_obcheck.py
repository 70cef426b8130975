#!/usr/bin/env python
"""obcheck over the port: the eight rule families (trace, mask, lock,
metric, time, io, cancel, rpc) over ``oceanbase_tpu_torch/`` and the
port's scripts (``scripts/torch_*.py``).

    python scripts/torch_obcheck.py                  # full report, exit 0
    python scripts/torch_obcheck.py --ci             # fail (exit 1) on NEW
                                                     # findings vs the baseline
    python scripts/torch_obcheck.py --ci --json      # one-line JSON summary
    python scripts/torch_obcheck.py --family io      # one family (repeatable;
                                                     # a full rule id works too)
    python scripts/torch_obcheck.py --write-baseline # refresh the baseline

The baseline (oceanbase_tpu_torch/analysis/baseline.json) is a multiset of
finding keys: pre-existing, audited findings land green in CI and only
new violations fail.  Audited single sites prefer an inline
``# obcheck: ok(<rule>)`` pragma over a baseline entry.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import Counter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# The checkers are pure stdlib AST analysis; pre-registering the parent
# package skips oceanbase_tpu_torch/__init__ (which imports torch —
# seconds of cold start the CLI never needs)
if "oceanbase_tpu_torch" not in sys.modules:
    import types

    _pkg = types.ModuleType("oceanbase_tpu_torch")
    _pkg.__path__ = [os.path.join(REPO, "oceanbase_tpu_torch")]
    sys.modules["oceanbase_tpu_torch"] = _pkg

from oceanbase_tpu_torch.analysis import (  # noqa: E402
    core,
    diff_findings,
    load_baseline,
    load_package_files,
    run_all,
    write_baseline,
)
from oceanbase_tpu_torch.analysis.cancel_rules import (  # noqa: E402
    check_cancel_rules,
)
from oceanbase_tpu_torch.analysis.io_rules import check_io_rules  # noqa: E402
from oceanbase_tpu_torch.analysis.lock_order import check_lock_order  # noqa: E402
from oceanbase_tpu_torch.analysis.mask_discipline import (  # noqa: E402
    check_mask_discipline,
)
from oceanbase_tpu_torch.analysis.metric_rules import (  # noqa: E402
    check_metric_rules,
)
from oceanbase_tpu_torch.analysis.rpc_rules import check_rpc_rules  # noqa: E402
from oceanbase_tpu_torch.analysis.time_rules import check_time_rules  # noqa: E402
from oceanbase_tpu_torch.analysis.trace_safety import check_trace_safety  # noqa: E402

CHECKERS = {
    "trace": check_trace_safety,
    "mask": check_mask_discipline,
    "lock": check_lock_order,
    "metric": check_metric_rules,
    "time": check_time_rules,
    "io": check_io_rules,
    "cancel": check_cancel_rules,
    "rpc": check_rpc_rules,
}


def _matches(rule: str, prefix: str) -> bool:
    return rule == prefix or rule.startswith(prefix + ".")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--ci", action="store_true",
                    help="diff against the baseline; exit 1 on new findings")
    ap.add_argument("--json", action="store_true",
                    help="emit a one-line JSON summary")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write the current findings as the new baseline")
    ap.add_argument("--root", default=REPO, help="repo root to scan")
    ap.add_argument("--baseline", default=core.BASELINE_PATH,
                    help="baseline file path")
    ap.add_argument("--family", action="append", default=None,
                    metavar="PREFIX",
                    help="only run/report rules matching this prefix "
                         "(repeatable; e.g. --family io --family "
                         "rpc.missing-policy)")
    args = ap.parse_args(argv)

    t0 = time.monotonic()
    files = load_package_files(args.root)
    selected = list(CHECKERS)
    if args.family:
        # a prefix selects its whole family to run, then narrows output
        selected = [r for r in selected
                    if any(_matches(p, r) or _matches(r, p)
                           for p in args.family)]
    if args.write_baseline and args.family:
        # a partial run must never overwrite the other families' entries
        print("obcheck: --write-baseline requires all rule families "
              "(drop --family)", file=sys.stderr)
        return 2
    checkers = [CHECKERS[r] for r in selected]
    timings: dict[str, float] = {}
    findings = run_all(files, checkers, timings=timings)
    if args.family:
        findings = [f for f in findings
                    if any(_matches(f.rule, p) for p in args.family)]
    baseline = load_baseline(args.baseline) if not args.write_baseline \
        else Counter()
    new = diff_findings(findings, baseline)

    if args.write_baseline:
        data = write_baseline(findings, args.baseline)
        print(f"baseline written: {data['total']} findings -> "
              f"{args.baseline}")
        return 0

    by_rule = Counter(f.rule for f in findings)
    if args.json:
        family_s = {fam: round(timings.get(fn.__name__, 0.0), 3)
                    for fam, fn in CHECKERS.items() if fam in selected}
        print(json.dumps({
            "metric": "obcheck",
            "files": len(files),
            "findings": len(findings),
            "new": len(new),
            "baselined": len(findings) - len(new),
            "by_rule": {k: by_rule[k] for k in sorted(by_rule)},
            "family_s": family_s,
            "duration_s": round(time.monotonic() - t0, 3),
        }))
    if not args.json or new:
        report = new if args.ci else findings
        for f in report:
            print(f.render(), file=sys.stderr if args.ci else sys.stdout)
    if not args.json and not args.ci:
        print(f"{len(findings)} findings ({len(new)} new, "
              f"{len(findings) - len(new)} baselined) across "
              f"{len(files)} files")
    if args.ci and new:
        print(f"obcheck: {len(new)} NEW finding(s); fix them, add an "
              f"audited '# obcheck: ok(<rule>)' pragma, or refresh the "
              f"baseline via --write-baseline", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
