#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/e2e_from_video.sh, which it
# mirrors stage for stage on instag_torch: one command from a raw video to
# a talking head + metrics.json (the full reference workflow, with no
# hand-built dataset directory).
#
# The "camera capture" is a rendered hard synthetic identity
# (instag_torch/data/synthetic_hard.py) whose GT stub satisfies the
# weights-gated preprocessing tasks (BiSeNet parsing / FAN landmarks /
# EasyPortrait teeth / OpenFace AUs); with real checkpoints mounted, drop
# --synthetic_gt and point at any real video. The port's capture is
# data/video.avi (MJPEG + PCM, read without OpenCV): the path the renderer
# returns is the one preprocessed. Every stage runs on the card.
#
# Usage: scripts/torch/e2e_from_video.sh [ROOT=$TMPDIR/e2e_full] [N_FRAMES=120] [SIZE=256] [ITERS=3000]
set -euo pipefail
ROOT="${1:-${TMPDIR:-/tmp}/e2e_full}"
N_FRAMES="${2:-120}"
SIZE="${3:-256}"
ITERS="${4:-3000}"
cd "$(dirname "$0")/../.."

echo "== 1/3 render raw capture (video.avi + aud.wav + GT stub) =="
VIDEO=$(python - "$ROOT" "$N_FRAMES" "$SIZE" <<'PY' | tail -n 1
import sys
from instag_torch.data.synthetic_hard import render_hard_video
root, n, size = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
video, stub = render_hard_video(root, n_frames=n, size=size, seed=0,
                                n_val=max(n // 10, 4))
print(video)
PY
)
echo "video: $VIDEO"

echo "== 2/3 preprocess (data_utils/process.py --task -1) =="
python -m instag_torch.data_utils.process "$VIDEO" \
    --task -1 --synthetic_gt "$ROOT/gt_stub"

echo "== 3/3 adapt (face+mouth+fuse) + metrics =="
python -m instag_torch.cli.adapt \
    --source_path "$ROOT/data" --model_path "$ROOT/out" \
    --init_num 1000 --mouth_init_num 2000 \
    --iterations "$ITERS" --fuse_iterations $((ITERS / 5)) --seed 0

cat "$ROOT/out/metrics.json"
