"""CLI: single-process few-shot adaptation (counterpart of
instag_tpu/cli/adapt.py): face -> mouth -> fuse -> synthesis -> metrics in
one process (the reference's train_xx_few.sh runs four), the bundles
passing in memory. It writes what the per-stage CLIs write, and
``metrics.json`` (PSNR and LPIPS of the val clip against its ground truth,
``lpips_real``, and the LMD when a landmark tracker is present).

    python -m instag_torch.cli.adapt -s data/<id> -m output/<id> \
        [--pretrain_path output/pretrain] [--long] [--iterations 10000] \
        [--fuse_iterations 2000] [--mouth_init_num 5000] [--dilate] \
        [--fast] [--skip_synthesis] [--no_lpips] [--data_parallel B] \
        [--device cuda]

``--data_parallel`` and ``torchrun`` as in ``cli.train_face``: the three
training stages run on every rank, and rank 0 alone writes the bundles
and runs the synthesis and the metrics.

The JAX CLI also compiles the mouth, fusion and synthesis programs in a
background thread while the face trains (``_warm_stage_compiles``,
``--no_warm_ahead``), to fill XLA's compile cache; eager PyTorch compiles
nothing ahead (the kernels are built once, at first use), so neither is
here, and no capability goes with them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..config import make_parser, parse_all, save_cfg
from ..data.dataset import load_frames
from ..io.checkpoints import (fuse_bundle, save_bundle, save_gaussian_ply,
                              train_bundle)
from ..io.from_jax import load_motion_net
from ..metrics import (evaluate_frames, lmd_from_landmarks,
                       load_gt_landmarks, track_video_landmarks)
from ..models.motion import MotionNetwork, MouthMotionNetwork
from ..parallel.mesh import shutdown
from ..synthesize import SynthesisModel, synthesize
from ..train.common import (FrameBatch, FrameMeta, build_frame_batch,
                            frame_source, load_training_frames,
                            streams_training_frames)
from ..train.face import train_face
from ..train.fuse import train_fuse
from ..train.mouth import train_mouth
from .train_face import add_port_args, load_pretrain, start_data_parallel


def build_parser():
    parser = make_parser("Single-process few-shot adaptation")
    parser.add_argument("--long", action="store_true")
    parser.add_argument("--pretrain_path", type=str, default="",
                        help="pretrain output dir holding "
                             "chkpnt_ema_{face,mouth}_latest.pkl")
    parser.add_argument("--fuse_iterations", type=int, default=2000)
    parser.add_argument("--mouth_init_num", type=int, default=0,
                        help="initial mouth-cloud size; 0 keeps --init_num")
    parser.add_argument("--dilate", action="store_true")
    parser.add_argument("--skip_synthesis", action="store_true")
    parser.add_argument("--fast", action="store_true",
                        help="skip the variant clips, PLY dumps and metrics")
    parser.add_argument("--no_lpips", action="store_true",
                        help="drop the perceptual-loss phases")
    add_port_args(parser)
    return parser


def main(argv=None) -> dict:
    mc, _, oc, args = parse_all(build_parser(), argv)
    group, dev, rank0 = start_data_parallel(args)
    dp = dict(data_parallel=args.data_parallel, group=group)
    t0 = time.time()

    def stage(name):
        if rank0:
            print(f"[adapt] {name} (t={time.time() - t0:.0f}s)", flush=True)

    def pretrained(which, net):
        p = os.path.join(args.pretrain_path, f"chkpnt_ema_{which}_latest.pkl")
        if not (args.pretrain_path and os.path.exists(p)):
            return None
        return load_motion_net(net(mc.audio_extractor), load_pretrain(p), dev)

    stream = streams_training_frames(mc)
    records = load_training_frames(mc, dev, stream)
    meta = FrameMeta.from_records(records)
    batch = frame_source(records, with_priors=True, stream=stream, device=dev)

    stage("train_face")
    mc.type = "face"
    face = train_face(mc, oc, batch, meta,
                      umf_net=pretrained("face", MotionNetwork),
                      long=args.long, seed=args.seed,
                      lpips_enabled=not args.no_lpips, device=dev, **dp)
    if rank0:
        save_cfg(mc.model_path, mc)
        save_bundle(os.path.join(mc.model_path, "chkpnt_face_latest.pkl"),
                    train_bundle(face, oc.iterations,
                                 max_sh_degree=face["max_sh_degree"]))
        save_gaussian_ply(os.path.join(
            mc.model_path, "point_cloud", f"iteration_{oc.iterations}_face",
            "point_cloud.ply"), face["state"])

    stage("train_mouth")
    mcm = dataclasses.replace(mc, type="mouth")
    if args.mouth_init_num > 0:
        mcm = dataclasses.replace(mcm, init_num=args.mouth_init_num)
    mouth = train_mouth(mcm, oc, batch, meta, face,
                        umf_net=pretrained("mouth", MouthMotionNetwork),
                        long=args.long, seed=args.seed, device=dev, **dp)
    if rank0:
        save_bundle(os.path.join(mc.model_path, "chkpnt_mouth_latest.pkl"),
                    train_bundle(mouth, oc.iterations))

    stage("train_fuse")
    # fusion opacity lr 1e-3, as the reference pipeline passes it
    ocf = dataclasses.replace(oc, iterations=args.fuse_iterations,
                              opacity_lr=1e-3)
    fuse_batch = (batch if isinstance(batch, FrameBatch)
                  else build_frame_batch(records, device=dev))
    fuse = train_fuse(mc, ocf, fuse_batch, face, mouth, seed=args.seed,
                      lpips_enabled=not args.no_lpips, device=dev, **dp)
    result = dict(face=face, mouth=mouth, fuse=fuse)
    if not rank0:
        return result
    save_bundle(os.path.join(mc.model_path, "chkpnt_fuse_latest.pkl"),
                fuse_bundle(fuse, args.fuse_iterations))

    if not args.skip_synthesis:
        stage("synthesize")
        model = SynthesisModel(**{k: fuse[k] for k in (
            "face_state", "mouth_state")}, **{k: fuse[f"{k}_net"] for k in (
                "face_umf", "mouth_umf", "face_pmf", "mouth_pmf")})
        out = os.path.join(mc.model_path, "out.mp4")
        video, fps = synthesize(
            mc, model, split="val", audio_file=mc.audio, dilate=args.dilate,
            out_path=out, dump_plys=0 if args.fast else 11,
            ply_dir=os.path.join(mc.model_path, "deformed_ply"),
            fast=args.fast, device=dev)
        print(f"[adapt] wrote {out}: {video.shape[0]} frames @ {fps:.1f} "
              f"FPS synthesis")
        result["video"] = video

        if not args.fast:
            stage("metrics")
            val_records = load_frames(mc.source_path, "val",
                                      mc.audio_extractor, -1, device=dev)
            gt = torch.stack([r.image for r in val_records]).cpu().numpy()
            scores = evaluate_frames(video, gt.astype(np.uint8), device=dev)
            n = min(len(video), len(val_records))
            gt_lms = load_gt_landmarks(
                mc.source_path, [r.img_id for r in val_records[:n]])
            if gt_lms is not None:
                pred_lms = track_video_landmarks(video[:n], dev)
                if pred_lms is not None:
                    scores["lmd"] = lmd_from_landmarks(pred_lms, gt_lms)
            path = os.path.join(mc.model_path, "metrics.json")
            with open(path, "w") as f:
                json.dump(scores, f, indent=1)
            print("[adapt] metrics: " + " ".join(
                f"{k}={v:.4f}" for k, v in scores.items()
                if isinstance(v, float)) + f" -> {path}")
            result["metrics"] = scores

    print(f"[adapt] total wall: {time.time() - t0:.0f}s", flush=True)
    return result


if __name__ == "__main__":
    main()
    shutdown()
