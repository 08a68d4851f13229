#!/bin/bash
# Full online RO-MAP pipeline demo on the PyTorch/CUDA port: C++ monocular
# SLAM frontend -> socket -> the port's NeRF runtime (romap_tpu_torch) on the
# GPU or the CPU -> evaluation artifacts. The twin of run_online_demo.sh.
#
# usage: examples/run_online_demo_torch.sh [out_dir] [train_iters] [cuda|cpu] [n_objects] [final_waves]
set -e
REPO="$(cd "$(dirname "$0")/.." && pwd)"
OUT="${1:-/tmp/romap_online_demo_torch}"
ITERS="${2:-100}"
DEVICE="${3:-cuda}"
NOBJ="${4:-1}"
FINALW="${5:-1}"
DATASET="$OUT/dataset"
SOCK="$OUT/monerf.sock"

mkdir -p "$OUT"
cmake -S "$REPO/native" -B "$REPO/native/build" -G Ninja >/dev/null
cmake --build "$REPO/native/build" >/dev/null

echo "== generating synthetic dataset =="
# ROMAP_DEMO_SEED varies the scene draw (object placement/texture).
# ROMAP_DEMO_SCENE selects the scene: room (default) or an adversarial
# variant (concave | boxnoise | compound | exposure — world.py).
SEED="${ROMAP_DEMO_SEED:-0}"
SCENE="${ROMAP_DEMO_SCENE:-room}"
PYTHONPATH="$REPO:$PYTHONPATH" python -c "
from romap_tpu_torch.data import world
if '$SCENE' == 'room':
    world.write_room_dataset('$DATASET', n_objects=$NOBJ, seed=$SEED)
else:
    world.write_adversarial_dataset('$DATASET', '$SCENE', seed=$SEED)
print('dataset at $DATASET (scene $SCENE, seed $SEED)')"

# ROMAP_DEMO_SPARSE_DEPTH=1: enable the NeRF.UseSparseDepth yaml knob
# (SLAM ships its BA-refined sparse depth as a supervision channel)
[ -n "$ROMAP_DEMO_SPARSE_DEPTH" ] && \
  echo "NeRF.UseSparseDepth: 1" >> "$DATASET/config.yaml"

echo "== starting NeRF runtime server (torch, $DEVICE) =="
rm -f "$SOCK"
DEVICE_FLAG="--device $DEVICE"
[ "$DEVICE" = "cpu" ] && DEVICE_FLAG="$DEVICE_FLAG --small"
# ROMAP_DEMO_NO_FINAL_RETRAIN=1: keep the accumulated field at shutdown
# (reference-parity; A/B for the retrain-vs-midrun-poses interplay)
[ -n "$ROMAP_DEMO_NO_FINAL_RETRAIN" ] && \
  DEVICE_FLAG="$DEVICE_FLAG --no-final-retrain"
PYTHONPATH="$REPO:$PYTHONPATH" python -m romap_tpu_torch.runtime.server \
  --socket "$SOCK" --final-waves "$FINALW" $DEVICE_FLAG > "$OUT/server.log" 2>&1 &
SRV=$!
echo "$SRV" > "$OUT/server.pid"
MONO=""
# Kill both children on ANY exit path. TERM/INT are trapped explicitly:
# bash does not run the EXIT trap on an untrapped fatal signal, which would
# orphan the server (holding the GPU) when a caller's `timeout` fired.
# TERM first, then KILL after a grace period.
cleanup() {
  [ -n "$MONO" ] && kill "$MONO" 2>/dev/null
  kill "$SRV" 2>/dev/null
  for i in $(seq 1 10); do kill -0 "$SRV" 2>/dev/null || break; sleep 1; done
  kill -9 "$SRV" 2>/dev/null
  rm -f "$OUT/server.pid"
  return 0
}
trap cleanup EXIT
trap 'cleanup; exit 143' TERM INT
for i in $(seq 1 120); do [ -S "$SOCK" ] && break; sleep 1; done

echo "== running mono_tum (SLAM + online NeRF) =="
# Run in the background and `wait` (interruptible) — a foreground child
# would defer bash's signal traps until it exited on its own.
"$REPO/native/build/mono_tum" "$DATASET" "$SOCK" "$ITERS" "$OUT" & MONO=$!
wait "$MONO"
MONO=""

echo "== artifacts =="
ls "$OUT"
ls "$OUT/0" 2>/dev/null || true

echo "== evaluation (PSNR/SSIM/mask IoU over held-out renders) =="
PYTHONPATH="$REPO:$PYTHONPATH" python -m romap_tpu_torch.utils.eval_psnr \
  "$OUT" "$DATASET" --json "$OUT/eval.json" || true
cat "$OUT/eval.json" 2>/dev/null || true
