#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/train_long.sh, which it
# mirrors stage for stage and flag for flag on instag_torch: long-video
# adaptation (the reference repo's scripts/train_xx_long.sh), all frames,
# --long schedules, sh_degree 2. Every stage runs on the card.
# Usage: bash scripts/torch/train_long.sh <data_dir> <out_dir> [pretrain_dir] [extractor]
set -euo pipefail
DATA=${1:?preprocessed identity dir}
OUT=${2:?output dir}
PRETRAIN=${3:-}
EXTRACTOR=${4:-deepspeech}

FACE_PRE=""
MOUTH_PRE=""
if [[ -n "$PRETRAIN" ]]; then
    FACE_PRE="--pretrain_path $PRETRAIN/chkpnt_ema_face_latest.pkl"
    MOUTH_PRE="--pretrain_path $PRETRAIN/chkpnt_ema_mouth_latest.pkl"
fi

python -m instag_torch.cli.train_face \
    --source_path "$DATA" --model_path "$OUT" \
    --audio_extractor "$EXTRACTOR" --type face \
    --init_num 2000 --densify_grad_threshold 0.0005 \
    --N_views -1 --iterations 10000 --long $FACE_PRE

python -m instag_torch.cli.train_mouth \
    --source_path "$DATA" --model_path "$OUT" \
    --audio_extractor "$EXTRACTOR" --type mouth \
    --init_num 5000 --N_views -1 --iterations 10000 --long $MOUTH_PRE

python -m instag_torch.cli.train_fuse_con \
    --source_path "$DATA" --model_path "$OUT" \
    --audio_extractor "$EXTRACTOR" --iterations 2000 \
    --opacity_lr 0.001

python -m instag_torch.cli.synthesize_fuse \
    --source_path "$DATA" --model_path "$OUT" --dilate

# close the eval loop (train_xx_long.sh last line)
python -m instag_torch.cli.metrics \
    --pred "$OUT/out.mp4" --gt "$OUT/gt.mp4" --track
