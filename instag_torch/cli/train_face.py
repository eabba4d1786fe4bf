"""CLI: few-shot face adaptation (counterpart of
instag_tpu/cli/train_face.py).

    python -m instag_torch.cli.train_face -s data/<id> -m output/<run> \
        --iterations 10000 --N_views 250 --init_num 1000 [--long] \
        [--pretrain_path output/pretrain/chkpnt_ema_face_latest.pkl] \
        [--start_checkpoint output/<run>/chkpnt_face_latest.pkl] \
        [--test_every 2000] [--seed 0] [--data_parallel B] [--device cuda]

    torchrun --standalone --nproc_per_node W -m instag_torch.cli.train_face \
        -s data/<id> -m output/<run> --data_parallel B

``--data_parallel B`` trains B frames a step (JAX's ``--data_parallel``):
on one card all B in one process, under ``torchrun`` ``B / W`` on each of
W ranks (W must divide B), one card a rank (NCCL), rank 0 alone writing
the outputs and logs.

Writes ``<model_path>/cfg_args.json``, ``chkpnt_face_latest.pkl`` (the JAX
CLI's bundle, which either package reads) and
``point_cloud/iteration_<n>_face/point_cloud.ply``; the val reporter logs
to ``<model_path>/metrics.jsonl`` and ``val_renders/``. A pretrain bundle
gives the UMF (its ``ema_params`` when present); ``--start_checkpoint``
resumes a face bundle of either package from its iteration, with the
curriculum's draws restarted (``train.face.train_face``).
"""

from __future__ import annotations

import os

import torch.distributed as dist

from ..config import make_parser, parse_all, save_cfg
from ..data.dataset import load_frames
from ..io.checkpoints import (load_bundle, save_bundle, save_gaussian_ply,
                              train_bundle)
from ..io.from_jax import load_motion_net
from ..models.motion import MotionNetwork
from ..parallel.mesh import init_distributed, shutdown
from ..train.common import (FrameMeta, build_frame_batch, frame_source,
                            load_training_frames, streams_training_frames)
from ..train.face import train_face


def add_port_args(parser) -> None:
    """The flags every adaptation CLI shares: ``--seed``,
    ``--data_parallel`` and ``--device``."""
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--data_parallel", type=int, default=1,
                        help="frames per optimizer step; under torchrun each "
                             "of the W ranks trains B / W of them")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")


def start_data_parallel(args):
    """``(group, device, rank0)`` of the run: the process group that
    ``torchrun`` describes (``None`` for one process), this rank's device
    and whether this is rank 0. Refuses, before joining the group, a
    ``--data_parallel`` that the world size does not divide."""
    w = (dist.get_world_size() if dist.is_initialized()
         else int(os.environ.get("WORLD_SIZE", "1")))
    if args.data_parallel < 1 or args.data_parallel % w:
        raise SystemExit(
            f"--data_parallel {args.data_parallel}: the {w} ranks must "
            f"divide the frames of a step; pass a multiple of {w}")
    group, dev = init_distributed(args.device)
    return group, dev, group is None or dist.get_rank(group) == 0


def load_pretrain(path: str) -> dict:
    """A pretrain bundle's UMF flax tree, its EMA weights when present."""
    b = load_bundle(path)
    return b["ema_params"] if "ema_params" in b else b["umf_params"]


def main(argv=None) -> dict:
    parser = make_parser("Few-shot face adaptation")
    parser.add_argument("--long", action="store_true")
    parser.add_argument("--pretrain_path", type=str, default="")
    parser.add_argument("--start_checkpoint", type=str, default="")
    parser.add_argument("--test_every", type=int, default=0)
    add_port_args(parser)
    mc, _, oc, args = parse_all(parser, argv)
    mc.type = "face"
    group, dev, rank0 = start_data_parallel(args)

    umf_net = None
    if args.pretrain_path:
        umf_net = load_motion_net(MotionNetwork(mc.audio_extractor),
                                  load_pretrain(args.pretrain_path), dev)
    resume = (load_bundle(args.start_checkpoint) if args.start_checkpoint
              else None)
    stream = streams_training_frames(mc)
    records = load_training_frames(mc, dev, stream)
    batch = frame_source(records, with_priors=True, stream=stream, device=dev)
    val_batch = None
    if rank0 and (mc.model_path or args.test_every):
        try:
            val_batch = build_frame_batch(load_frames(
                mc.source_path, "val", mc.audio_extractor, -1, device=dev),
                device=dev)
        except FileNotFoundError:
            pass

    res = train_face(mc, oc, batch, FrameMeta.from_records(records),
                     umf_net=umf_net, long=args.long, seed=args.seed,
                     resume_bundle=resume, log_dir=mc.model_path or None,
                     test_every=args.test_every, val_batch=val_batch,
                     device=dev, data_parallel=args.data_parallel,
                     group=group)

    if rank0 and mc.model_path:
        save_cfg(mc.model_path, mc)
        save_bundle(os.path.join(mc.model_path, "chkpnt_face_latest.pkl"),
                    train_bundle(res, oc.iterations,
                                 max_sh_degree=res["max_sh_degree"]))
        save_gaussian_ply(os.path.join(
            mc.model_path, "point_cloud", f"iteration_{oc.iterations}_face",
            "point_cloud.ply"), res["state"])
    if rank0:
        print(f"train_face done: final loss "
              f"{sum(res['losses'][-50:]) / 50:.4f}")
    return res


if __name__ == "__main__":
    main()
    shutdown()
