#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/train_few.sh, which it
# mirrors stage for stage and flag for flag on instag_torch (the reference
# repo's scripts/train_xx_few.sh):
#   train_face (10k, N_views 250) -> train_mouth (10k) -> train_fuse (2k)
#   -> synthesize -> metrics
# Every stage runs on the card (the CLIs' default --device cuda).
# Usage: bash scripts/torch/train_few.sh <data_dir> <out_dir> [pretrain_dir] [extractor] [n_views]
set -euo pipefail
DATA=${1:?preprocessed identity dir}
OUT=${2:?output dir}
PRETRAIN=${3:-}
EXTRACTOR=${4:-deepspeech}
NVIEWS=${5:-250}

FACE_PRE=""
MOUTH_PRE=""
if [[ -n "$PRETRAIN" ]]; then
    FACE_PRE="--pretrain_path $PRETRAIN/chkpnt_ema_face_latest.pkl"
    MOUTH_PRE="--pretrain_path $PRETRAIN/chkpnt_ema_mouth_latest.pkl"
fi

# init_num / densify_grad_threshold follow the reference pipeline defaults
# (train_xx_few.sh:19-20: face 2000 @ 0.0005, mouth 5000)
python -m instag_torch.cli.train_face \
    --source_path "$DATA" --model_path "$OUT" \
    --audio_extractor "$EXTRACTOR" --type face \
    --init_num 2000 --densify_grad_threshold 0.0005 \
    --N_views "$NVIEWS" --iterations 10000 \
    --sh_degree 1 $FACE_PRE

python -m instag_torch.cli.train_mouth \
    --source_path "$DATA" --model_path "$OUT" \
    --audio_extractor "$EXTRACTOR" --type mouth \
    --init_num 5000 --N_views "$NVIEWS" --iterations 10000 $MOUTH_PRE

python -m instag_torch.cli.train_fuse_con \
    --source_path "$DATA" --model_path "$OUT" \
    --audio_extractor "$EXTRACTOR" --N_views "$NVIEWS" --iterations 2000 \
    --opacity_lr 0.001

python -m instag_torch.cli.synthesize_fuse \
    --source_path "$DATA" --model_path "$OUT" --dilate

# close the eval loop (reference train_xx_few.sh last line:
# metrics.py renders/out.mp4 gt/out.mp4)
python -m instag_torch.cli.metrics \
    --pred "$OUT/out.mp4" --gt "$OUT/gt.mp4" --track
