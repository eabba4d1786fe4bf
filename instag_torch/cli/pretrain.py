"""CLI: the pre-training chain in one process, face UMF then mouth UMF
(counterpart of instag_tpu/cli/pretrain.py; the reference's
scripts/pretrain_con.sh runs two processes).

    python -m instag_torch.cli.pretrain -s data/pretrain -m output/pretrain \
        [--init_num 2000] [--mouth_init_num 5000] [--iterations 30000] \
        [--densify_grad_threshold 5e-4] [--share_audio_net] [--skip_mouth] \
        [--data_list id_a,id_b] [--seed 0] [--identity_parallel] \
        [--device cuda]

It writes what ``pretrain_face`` and ``pretrain_mouth`` write; the face
result passes to the mouth stage in memory. ``--init_num`` and
``--densify_grad_threshold`` are the face stage's; the mouth stage starts
from ``--mouth_init_num`` splats and densifies at the default threshold,
as the reference script runs it. Then ``cli.adapt --pretrain_path
<model_path>`` adapts a new identity from the EMA bundles.
``--identity_parallel`` and ``torchrun`` as in ``cli.pretrain_face``, for
both stages.
"""

from __future__ import annotations

import dataclasses
import time

from ..config import OptimizationConfig, make_parser, parse_all, save_cfg
from ..device import resolve_device
from ..parallel.mesh import shutdown
from ..train.pretrain import pretrain_face, pretrain_mouth
from .pretrain_face import (add_pretrain_args, identity_list,
                            save_identities, save_stage,
                            start_identity_parallel)


def build_parser():
    parser = make_parser("Single-process pre-training chain (face -> mouth)")
    parser.add_argument("--share_audio_net", action="store_true",
                        help="tie every face PMF's audio encoder to the "
                             "UMF's")
    parser.add_argument("--mouth_init_num", type=int, default=5000)
    parser.add_argument("--skip_mouth", action="store_true")
    add_pretrain_args(parser)
    return parser


def main(argv=None) -> dict:
    mc, _, oc, args = parse_all(build_parser(), argv)
    resolve_device(args.device)     # no card: raise before reading anything
    data_list = identity_list(mc.source_path, args.data_list)
    group, dev, rank0 = start_identity_parallel(args, len(data_list))
    idp = dict(identity_parallel=args.identity_parallel, group=group)
    t0 = time.time()

    def stage(name):
        if rank0:
            print(f"[pretrain] {name} (t={time.time() - t0:.0f}s)",
                  flush=True)

    stage("pretrain_face")
    mcf = dataclasses.replace(mc, type="face")
    face = pretrain_face(mcf, oc, data_list, seed=args.seed,
                         share_audio_net=args.share_audio_net, device=dev,
                         **idp)
    if rank0:
        save_cfg(mc.model_path, mcf)
        save_stage(mc.model_path, "face", face)
        save_identities(mc.model_path, face)
    out = dict(face=face)

    if not args.skip_mouth:
        stage("pretrain_mouth")
        mcm = dataclasses.replace(mc, type="mouth",
                                  init_num=args.mouth_init_num)
        ocm = dataclasses.replace(
            oc, densify_grad_threshold=OptimizationConfig()
            .densify_grad_threshold)
        out["mouth"] = pretrain_mouth(mcm, ocm, data_list, face,
                                      seed=args.seed, device=dev, **idp)
        if rank0:
            save_stage(mc.model_path, "mouth", out["mouth"])
    if rank0:
        print(f"[pretrain] total wall: {time.time() - t0:.0f}s", flush=True)
    return out


if __name__ == "__main__":
    main()
    shutdown()
