#!/usr/bin/env bash
# The PyTorch/CUDA port's counterpart of scripts/pretrain_con.sh, which it
# mirrors flag for flag on instag_torch (the reference repo's
# scripts/pretrain_con.sh):
#   face UMF (init 2000, grad thresh 5e-4, 30k iters/identity)
#   -> mouth UMF (init 5000, 30k iters/identity)
# Usage: bash scripts/torch/pretrain_con.sh <dataset_root> <out_dir> [audio_extractor]
# The esperanto/hubert variants pass --share_audio_net, matching the
# reference's pretrain_con_eo.sh:8 / pretrain_con_hu.sh:8. Runs on the card.
set -euo pipefail
DATA=${1:?dataset root containing per-identity dirs}
OUT=${2:?output dir}
EXTRACTOR=${3:-deepspeech}

SHARE=""
if [ "$EXTRACTOR" = "esperanto" ] || [ "$EXTRACTOR" = "hubert" ]; then
    SHARE="--share_audio_net"
fi

# One process for the chain: the face result passes to the mouth stage in
# memory. The per-stage CLIs (cli.pretrain_face / cli.pretrain_mouth)
# remain available and save identical artifacts.
python -m instag_torch.cli.pretrain \
    --source_path "$DATA" --model_path "$OUT" \
    --audio_extractor "$EXTRACTOR" \
    --init_num 2000 --mouth_init_num 5000 \
    --iterations 30000 --densify_grad_threshold 5e-4 $SHARE
