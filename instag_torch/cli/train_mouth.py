"""CLI: few-shot mouth adaptation (counterpart of
instag_tpu/cli/train_mouth.py).

    python -m instag_torch.cli.train_mouth -s data/<id> -m output/<run> \
        --iterations 10000 [--long] [--pretrain_path ...] \
        [--start_checkpoint output/<run>/chkpnt_mouth_latest.pkl] \
        [--seed 0] [--data_parallel B] [--device cuda]

Reads the run's ``chkpnt_face_latest.pkl`` (either package's) for the
frozen face branch, and writes ``chkpnt_mouth_latest.pkl`` and
``point_cloud/iteration_<n>_mouth/point_cloud.ply``. ``--data_parallel``
and ``torchrun`` as in ``cli.train_face``.
"""

from __future__ import annotations

import os

from ..config import make_parser, parse_all
from ..io.checkpoints import (load_branch, load_bundle, save_bundle,
                              save_gaussian_ply, train_bundle)
from ..io.from_jax import load_motion_net
from ..models.motion import MouthMotionNetwork
from ..parallel.mesh import shutdown
from ..train.common import (FrameMeta, frame_source, load_training_frames,
                            streams_training_frames)
from ..train.mouth import train_mouth
from .train_face import add_port_args, load_pretrain, start_data_parallel


def build_parser():
    parser = make_parser("Few-shot mouth adaptation")
    parser.add_argument("--long", action="store_true")
    parser.add_argument("--pretrain_path", type=str, default="")
    parser.add_argument("--start_checkpoint", type=str, default="")
    add_port_args(parser)
    return parser


def main(argv=None) -> dict:
    mc, _, oc, args = parse_all(build_parser(), argv)
    mc.type = "mouth"
    group, dev, rank0 = start_data_parallel(args)

    face = load_branch(os.path.join(mc.model_path, "chkpnt_face_latest.pkl"),
                       "face", mc.audio_extractor, dev)
    umf_net = None
    if args.pretrain_path:
        umf_net = load_motion_net(MouthMotionNetwork(mc.audio_extractor),
                                  load_pretrain(args.pretrain_path), dev)
    resume = (load_bundle(args.start_checkpoint) if args.start_checkpoint
              else None)
    stream = streams_training_frames(mc)
    records = load_training_frames(mc, dev, stream)
    batch = frame_source(records, stream=stream, device=dev)
    res = train_mouth(mc, oc, batch, FrameMeta.from_records(records), face,
                      umf_net=umf_net, long=args.long, seed=args.seed,
                      resume_bundle=resume, device=dev,
                      data_parallel=args.data_parallel, group=group)

    if rank0:
        save_bundle(os.path.join(mc.model_path, "chkpnt_mouth_latest.pkl"),
                    train_bundle(res, oc.iterations))
        save_gaussian_ply(os.path.join(
            mc.model_path, "point_cloud", f"iteration_{oc.iterations}_mouth",
            "point_cloud.ply"), res["state"])
    if rank0:
        print(f"train_mouth done: final loss "
              f"{sum(res['losses'][-50:]) / 50:.4f}")
    return res


if __name__ == "__main__":
    main()
    shutdown()
