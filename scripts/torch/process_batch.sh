#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/process_batch.sh, which it
# mirrors on instag_torch: batch preprocessing over a directory of identity
# folders each containing <name>.mp4 (the reference repo's
# scripts/process_MEAD.sh / process_emotions.sh). Runs on the card.
# Usage: bash scripts/torch/process_batch.sh <root_dir> [asr]
set -euo pipefail
ROOT=${1:?root dir of identity folders}
ASR=${2:-esperanto}

for dir in "$ROOT"/*/; do
    name=$(basename "$dir")
    vid=$(ls "$dir"/*.mp4 2>/dev/null | head -1 || true)
    if [[ -z "$vid" ]]; then
        echo "[skip] no mp4 in $dir"
        continue
    fi
    echo "=== processing $name ==="
    python -m instag_torch.data_utils.process "$vid" --asr "$ASR"
done
