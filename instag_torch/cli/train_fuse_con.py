"""CLI: joint fusion fine-tune (counterpart of
instag_tpu/cli/train_fuse_con.py).

    python -m instag_torch.cli.train_fuse_con -s data/<id> -m output/<run> \
        --iterations 2000 [--seed 0] [--data_parallel B] [--device cuda]

Reads the run's ``chkpnt_face_latest.pkl`` and ``chkpnt_mouth_latest.pkl``
(either package's) and writes ``chkpnt_fuse_latest.pkl``, which
``cli.synthesize_fuse`` reads. ``--data_parallel`` and ``torchrun`` as in
``cli.train_face``.
"""

from __future__ import annotations

import os

from ..config import make_parser, parse_all
from ..io.checkpoints import fuse_bundle, load_branch, save_bundle
from ..parallel.mesh import shutdown
from ..train.common import build_frame_batch, load_training_frames
from ..train.fuse import train_fuse
from .train_face import add_port_args, start_data_parallel


def main(argv=None) -> dict:
    parser = make_parser("Fusion fine-tune")
    add_port_args(parser)
    mc, _, oc, args = parse_all(parser, argv)
    group, dev, rank0 = start_data_parallel(args)

    face, mouth = (load_branch(os.path.join(
        mc.model_path, f"chkpnt_{b}_latest.pkl"), b, mc.audio_extractor, dev)
        for b in ("face", "mouth"))
    batch = build_frame_batch(load_training_frames(mc, dev), device=dev)
    res = train_fuse(mc, oc, batch, face, mouth, seed=args.seed, device=dev,
                     data_parallel=args.data_parallel, group=group)

    if rank0:
        save_bundle(os.path.join(mc.model_path, "chkpnt_fuse_latest.pkl"),
                    fuse_bundle(res, oc.iterations))
    if rank0:
        print(f"train_fuse done: final loss "
              f"{sum(res['losses'][-50:]) / 50:.4f}")
    return res


if __name__ == "__main__":
    main()
    shutdown()
