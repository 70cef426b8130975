#!/usr/bin/env bash
# The port's local CI gate, the twin of scripts/ci.sh, in the same order:
#   1. obcheck --ci   the eight static rule families over the port
#                     (scripts/torch_obcheck.py) vs its baseline
#   2. poison         the port's poison-lane parity tests (the Static-shape
#                     policy's dynamic check, analysis/poison.py)
#   3. tier-1         the non-slow tests/test_torch_*.py
# Prints one PASS/FAIL line per stage and exits non-zero if any failed.
#
#   scripts/torch_ci.sh
#   CI_PYTEST_ARGS="-n 6 --dist loadfile" scripts/torch_ci.sh
#
# CI_PYTEST_ARGS is added to both pytest stages (the tests hold the port
# against the JAX package on the CPU, so JAX_PLATFORMS defaults to cpu).
# The standing contracts run out of band, on the card:
#   python3 scripts/torch_{trace,metrics,workload,planqual,scrub}_bench.py
set -u
cd "$(dirname "$0")/.."

export JAX_PLATFORMS="${JAX_PLATFORMS:-cpu}"
read -r -a extra <<< "${CI_PYTEST_ARGS:-}"

names=()
results=()
overall=0

run_stage() {
    name="$1"; shift
    echo "=== $name: $*"
    if "$@"; then
        names+=("$name"); results+=("PASS")
    else
        names+=("$name"); results+=("FAIL"); overall=1
    fi
    echo
}

run_stage "obcheck" python scripts/torch_obcheck.py --ci
run_stage "poison" python -m pytest tests/test_torch_*.py -q -m "not slow" \
    -k poison -p no:cacheprovider "${extra[@]}"
run_stage "tier-1" python -m pytest tests/test_torch_*.py -q -m "not slow" \
    -p no:cacheprovider "${extra[@]}"

echo "==== local CI summary ===="
for i in "${!names[@]}"; do
    printf '  %-8s %s\n' "${names[$i]}" "${results[$i]}"
done
if [ "$overall" -eq 0 ]; then
    echo "RESULT: PASS"
else
    echo "RESULT: FAIL"
fi
exit "$overall"
