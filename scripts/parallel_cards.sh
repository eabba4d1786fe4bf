#!/usr/bin/env bash
# The port's parallel modes on every card of one host, one process a card
# over NCCL (torchrun):
#   1. cli.train_face --data_parallel 2N on a generated 512x512 scene,
#      against the same run with --data_parallel 2N on one card;
#   2. cli.pretrain_face --identity_parallel on N generated identities.
# Writes its scenes and runs under $WORK (default .chip_ab/parallel_cards,
# git-ignored) and prints each run's wall time and final loss.
#
#     bash scripts/parallel_cards.sh [N] [ITERS]
set -euo pipefail
cd "$(dirname "$0")/.."
N=${1:-$(nvidia-smi -L | wc -l)}
ITERS=${2:-60}
B=$((2 * N))
WORK=${WORK:-.chip_ab/parallel_cards}
rm -rf "$WORK" && mkdir -p "$WORK"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader

python3 - "$WORK" "$N" <<'EOF'
import sys, time
from instag_torch import kernels
from instag_torch.data.synthetic import generate_scene
work, n = sys.argv[1], int(sys.argv[2])
t = time.perf_counter()
kernels.build(["composite_fwd", "composite_bwd", "scatter_add"])
print(f"build: {time.perf_counter() - t:.1f} s", flush=True)
generate_scene(f"{work}/scene", n_frames=16, size=512, n_val=2,
               device="cuda")
for k in range(n):
    generate_scene(f"{work}/ids/id_{k}", n_frames=8, size=512, n_val=1,
                   seed=20 + k, variation=0.3, device="cuda")
EOF

run() {  # label, command...
    local label=$1; shift
    local t0=$(date +%s%N)
    "$@" > "$WORK/$label.log" 2>&1 || { tail -n 30 "$WORK/$label.log"; exit 1; }
    local t1=$(date +%s%N)
    echo "$label: exit 0 in $(( (t1 - t0) / 1000000 )) ms;" \
         "$(grep -h 'done' "$WORK/$label.log" | head -n 1)"
}
ADAPT=(-s "$WORK/scene" --iterations "$ITERS" --data_parallel "$B")
run dp_one_card python3 -m instag_torch.cli.train_face "${ADAPT[@]}" \
    -m "$WORK/run_one"
run dp_${N}_cards torchrun --standalone --nproc_per_node "$N" \
    -m instag_torch.cli.train_face "${ADAPT[@]}" -m "$WORK/run_n"
run idp_${N}_cards torchrun --standalone --nproc_per_node "$N" \
    -m instag_torch.cli.pretrain_face -s "$WORK/ids" -m "$WORK/pre" \
    --identity_parallel --iterations "$ITERS" --init_num 2000
python3 - "$WORK" <<'EOF'
import sys
import numpy as np
from instag_torch.io.checkpoints import bundle_list, load_bundle
work = sys.argv[1]
a = load_bundle(f"{work}/run_one/chkpnt_face_latest.pkl")
b = load_bundle(f"{work}/run_n/chkpnt_face_latest.pkl")
d = max(float(np.abs(a["state"]["params"][k]
                     - b["state"]["params"][k]).max())
        for k in ("xyz", "features_dc", "opacity", "scaling"))
print(f"one card vs the ranks, final cloud: max |difference| {d:.3e} "
      "(fp32 summation order and the scatter's atomics)")
p = load_bundle(f"{work}/pre/chkpnt_ema_face_latest.pkl")
print(f"identity-parallel bundle: identities {bundle_list(p['data_list'])}")
EOF
