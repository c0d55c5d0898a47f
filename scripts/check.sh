#!/usr/bin/env bash
# Pre-snapshot check gate — the answer to the reference's always-run
# `check-neptune` target (scripts/build.sh:201-239, lit wiring in
# test/CMakeLists.txt:31-44): a broken tree must not ship silently.
#
# Usage:
#   scripts/check.sh          # fast tier (~2-3 min): core IR/frontend/tools/
#                             # golden + NumPy-oracle apply parity + periodic +
#                             # fuzz oracles
#   scripts/check.sh --full   # the whole pytest suite
#
# On a machine with an NVIDIA GPU, `python chip_smoke.py` is the quickest
# proof that the system still runs on the card.
set -euo pipefail
cd "$(dirname "$0")/.."

FAST_TIER=(
  tests/test_ir.py
  tests/test_frontend.py
  tests/test_tools.py
  tests/test_golden.py
  tests/test_executor.py
  tests/test_apply_oracle.py
  tests/test_periodic.py
  tests/test_fuzz.py
  tests/test_review_regressions.py
  tests/test_review2_regressions.py
  tests/test_fold.py
)

if [[ "${1:-}" == "--full" ]]; then
  python -m pytest tests/ -q
else
  python -m pytest "${FAST_TIER[@]}" -q
fi
echo "check.sh: OK"
