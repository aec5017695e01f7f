#!/usr/bin/env bash
# Black-box benchmark of the PyTorch/CUDA port's server: boot
# `python -m dusk_blindbidproof_tpu_torch.server`, wait for its socket (up to
# 300 s), run N timed prove + verify round trips over it with
# scripts/uds_client_torch.py --bench N, kill the exact server PID and pass on
# the client's exit status.  Without a GPU the server exits at boot and so
# does this script, non-zero.
#
# Usage: scripts/bench-uds-torch.sh [N]    (N defaults to 8)
set -u
cd "$(dirname "$0")/.."
SOCK="${TMPDIR:-/tmp}/dusk-uds-blindbid-torch-bench-$$"
N="${1:-8}"

python -m dusk_blindbidproof_tpu_torch.server --bind-path "$SOCK" --log-level warn &
SERVER_PID=$!
for _ in $(seq 1 600); do
  [ -S "$SOCK" ] && break
  kill -0 "$SERVER_PID" 2>/dev/null || { echo 'server died at boot' >&2; exit 1; }
  sleep 0.5
done
[ -S "$SOCK" ] || { echo 'server did not listen within 300 s' >&2; kill -9 "$SERVER_PID"; exit 1; }

python scripts/uds_client_torch.py --bind-path "$SOCK" --bench "$N"
STATUS=$?

kill -15 "$SERVER_PID" 2>/dev/null
wait "$SERVER_PID" 2>/dev/null
rm -f "$SOCK"
exit $STATUS
