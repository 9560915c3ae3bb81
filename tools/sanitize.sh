#!/usr/bin/env bash
# Reproducible TSAN + ASAN runs over the native runtime's threaded paths
# (VERDICT r1 item 7: the PARITY.md sanitizer claims must be one command,
# not a story). Exits non-zero on any sanitizer report.
#
#   tools/sanitize.sh            # both sanitizers
#   tools/sanitize.sh tsan|asan  # one of them
set -euo pipefail
cd "$(dirname "$0")/.."
SRC=entreepy_tpu/runtime/native.cpp
OUT=${TMPDIR:-/tmp}/entreepy_sanitize
mkdir -p "$OUT"

run_one() {
  local kind=$1 flag=$2 runtime_so
  runtime_so=$(g++ -print-file-name=lib${kind}.so)
  echo "== ${kind}: building =="
  g++ -O1 -g -fsanitize="$flag" -shared -fPIC -pthread \
      -o "$OUT/native_${kind}.so" "$SRC"
  echo "== ${kind}: running driver =="
  local env_extra=()
  if [ "$kind" = tsan ]; then
    env_extra=(TSAN_OPTIONS="halt_on_error=1 exitcode=66")
  else
    # leak detection off: the long-lived python interpreter is not the SUT
    env_extra=(ASAN_OPTIONS="detect_leaks=0:halt_on_error=1:exitcode=66:verify_asan_link_order=0")
  fi
  env "${env_extra[@]}" \
      LD_PRELOAD="$runtime_so" \
      ENTREEPY_NATIVE_LIB="$OUT/native_${kind}.so" \
      JAX_PLATFORMS=cpu \
      python tools/_sanitize_driver.py
  echo "== ${kind}: clean =="
}

case "${1:-all}" in
  tsan) run_one tsan thread ;;
  asan) run_one asan address ;;
  all)  run_one tsan thread; run_one asan address ;;
  *) echo "usage: $0 [tsan|asan|all]" >&2; exit 2 ;;
esac
