#!/bin/bash
# Sequential per-file CPU test runner with progressive timing.
#
# Each file runs in its OWN pytest process and is retried once on a
# non-pytest exit (e.g. the jax 0.9.0 persistent-cache writer segfault,
# exit >= 128) with cache WRITES disabled (reads still hit) — a crash
# therefore only costs one file, not the run.
LOG=${1:-/tmp/jolt_tests.log}
TMPOUT=$(mktemp)
: > "$LOG"
overall=0
for f in $(ls tests/test_*.py); do
  start=$(date +%s)
  JAX_PLATFORMS=cpu timeout 7200 python -m pytest "$f" -q -m "not slow" > "$TMPOUT" 2>&1
  rc=$?
  if [ $rc -ge 128 ]; then
    echo "[retry after signal $((rc-128)), cache writes off] $f" >> "$LOG"
    JAX_PLATFORMS=cpu JOLT_TEST_NO_CACHE_WRITE=1 timeout 7200 \
        python -m pytest "$f" -q -m "not slow" > "$TMPOUT" 2>&1
    rc=$?
  fi
  end=$(date +%s)
  [ $rc -ne 0 ] && overall=1
  echo "[$((end-start))s rc=$rc] $f :: $(tail -2 "$TMPOUT" | tr '\n' ' ')" >> "$LOG"
done
rm -f "$TMPOUT"
echo "ALL DONE overall_rc=$overall" >> "$LOG"
exit $overall
