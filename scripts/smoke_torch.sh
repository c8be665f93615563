#!/usr/bin/env bash
# Smoke check of the PyTorch port (src/repro_torch) end to end, on the
# CUDA device by default:
#   1. a tiered ReAct workflow under page pressure (26 device pages, a
#      64 MiB host tier): demotions and host-tier hits, every task done;
#   2. the HTTP launcher's graceful drain: SIGTERM mid-stream, a fresh
#      request refused with 503 "draining", the open stream finished, no
#      watchdog trip, exit code 0.
#
#   scripts/smoke_torch.sh                 # on the card
#   scripts/smoke_torch.sh --device cpu    # the plain versions on the CPU
#
# Extra arguments go to ``python -m repro_torch.launch.serve``; logs go to
# build/smoke_torch/.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"
LOG_DIR=build/smoke_torch
mkdir -p "$LOG_DIR"
DEVICE=cuda
for ((i = 1; i <= $#; i++)); do
  if [ "${!i}" = "--device" ]; then j=$((i + 1)); DEVICE="${!j}"; fi
done

echo "== tiered ReAct workflow under page pressure (repro_torch, $DEVICE) =="
DEVICE="$DEVICE" python - <<'PY'
import os

from repro_torch.configs.paper_models import tiny_serving_model
from repro_torch.core.config import ServeConfig
from repro_torch.models import transformer as tfm
from repro_torch.serving.api import ForkServer
from repro_torch.serving.workflows import WorkflowConfig, WorkflowDriver

dev = os.environ["DEVICE"]
cfg = tiny_serving_model(rank=8)
params = tfm.init_params(cfg, 0, device=dev)
lora = tfm.init_lora_stacks(cfg, 1, 8, device=dev)
sc = ServeConfig(page_size=16, max_pages=26, max_batch=4,
                 max_prefill_tokens=64, mode="forkkv",
                 max_pages_per_req=24, host_tier_bytes=64 << 20)
server = ForkServer(cfg, params, lora, sc, device=dev)
wf = WorkflowConfig(n_workflows=3, agents_per_workflow=2, rounds=2,
                    shared_context_len=256, instr_len=16, tool_obs_len=24,
                    max_new_tokens=4, vocab=cfg.vocab_size, seed=0)
rep = WorkflowDriver(server, wf).run_react()
assert rep["tasks_done"] == 12, rep["tasks_done"]
assert rep["demoted_pages"] > 0, "expected demotions under pressure"
assert rep["tier_hits"] > 0, "expected host-tier promotions"
assert rep["exec_errors"] == 0, rep["exec_errors"]
eng = server.engine
assert eng.base_pool.free_pages + eng.base_pool.used_pages == 26
print(f"tiered e2e OK on {eng.executor.device}: tasks={rep['tasks_done']} "
      f"tier_hits={rep['tier_hits']} demoted={rep['demoted_pages']} "
      f"promoted_bytes={rep['promoted_bytes']}")
PY

echo "== HTTP launcher: graceful drain (SIGTERM mid-stream) =="
python -m repro_torch.launch.serve --http --port 0 --max-pages 256 "$@" \
  > "$LOG_DIR/http.log" 2>&1 &
HTTP_PID=$!
trap 'kill $HTTP_PID 2>/dev/null || true' EXIT
for _ in $(seq 300); do
  grep -q "on http://" "$LOG_DIR/http.log" && break
  kill -0 $HTTP_PID 2>/dev/null || break
  sleep 1
done
HTTP_PORT=$(sed -n 's#^serving mode=.* on http://[^:]*:\([0-9]*\)$#\1#p' \
  "$LOG_DIR/http.log")
test -n "$HTTP_PORT" || { cat "$LOG_DIR/http.log"; exit 1; }
HTTP_PORT="$HTTP_PORT" HTTP_PID="$HTTP_PID" python - <<'PY'
import os
import signal
import time

from repro_torch.serving.frontend import ForkClient, HttpError

client = ForkClient(port=int(os.environ["HTTP_PORT"]))
assert client.healthz()
prompt = [(7 * i + 3) % 1000 for i in range(48)]
# one long stream in flight, then SIGTERM: the stream runs to its end
# while new work is refused with 503 + finish_reason="draining"
stream = client.stream_completion(prompt, max_new_tokens=128)
first = next(stream)
assert not first.get("finished"), first
os.kill(int(os.environ["HTTP_PID"]), signal.SIGTERM)
deadline = time.time() + 30
while True:
    status, _, doc = client._request("GET", "/healthz")
    if doc["state"] == "draining" or time.time() > deadline:
        break
    time.sleep(0.01)
assert doc["state"] == "draining" and status == 503, (status, doc)
assert doc["watchdog_trips"] == 0, doc
try:
    client.completion(prompt[:32], max_new_tokens=2)
    raise SystemExit("new request admitted during drain")
except HttpError as exc:
    assert exc.status == 503, exc.status
    assert exc.doc.get("finish_reason") == "draining", exc.doc
    assert float(exc.headers.get("retry-after", 0)) >= 1.0
events = [first] + list(stream)
assert events[-1]["finished"] and len(events[-1]["tokens"]) == 128, \
    events[-1]
print("drain OK: in-flight stream finished, new requests 503, "
      "watchdog_trips 0")
PY
DRAIN_RC=0
wait $HTTP_PID || DRAIN_RC=$?
test "$DRAIN_RC" -eq 0 || {
  echo "drained server exited rc=$DRAIN_RC"; cat "$LOG_DIR/http.log"; exit 1; }
grep -q "drain: complete, exiting" "$LOG_DIR/http.log" || {
  cat "$LOG_DIR/http.log"; exit 1; }
trap - EXIT
echo "smoke_torch OK"
