"""CLI: multi-identity mouth UMF pre-training (counterpart of
instag_tpu/cli/pretrain_mouth.py), under a face pre-training run of either
package in the same ``--model_path``.

    python -m instag_torch.cli.pretrain_mouth -s data/pretrain \
        -m output/pretrain --init_num 5000 --iterations 30000 \
        [--data_list id_a,id_b] [--seed 0] [--identity_parallel] \
        [--device cuda]

Reads ``chkpnt_ema_face_latest.pkl`` (the frozen face UMF, and the
identities when ``--data_list`` is not given) and each
``<identity>_face_latest.pkl`` (the frozen face cloud); writes
``chkpnt_mouth_latest.pkl`` and ``chkpnt_ema_mouth_latest.pkl``.
``--identity_parallel`` and ``torchrun`` as in ``cli.pretrain_face``.
"""

from __future__ import annotations

import os

from ..config import make_parser, parse_all
from ..device import resolve_device
from ..io.checkpoints import bundle_list, load_bundle, state_from_dict
from ..io.from_jax import load_motion_net
from ..models.motion import MotionNetwork
from ..parallel.mesh import shutdown
from ..train.pretrain import pretrain_mouth
from .pretrain_face import (add_pretrain_args, save_stage,
                            start_identity_parallel)


def face_identities(model_path: str) -> list[str]:
    """The identities of the face pre-training run in ``model_path``."""
    return bundle_list(load_bundle(os.path.join(
        model_path, "chkpnt_ema_face_latest.pkl"))["data_list"])


def load_face_result(model_path: str, data_list: list[str] | None,
                     audio_extractor: str, device) -> tuple[dict, list]:
    """The face pre-training result ``pretrain_mouth`` runs under, from the
    bundles in ``model_path``: (``{"states", "ema_net"}``, the identities,
    ``data_list`` or the EMA bundle's)."""
    face_ema = load_bundle(os.path.join(model_path,
                                        "chkpnt_ema_face_latest.pkl"))
    names = data_list or bundle_list(face_ema["data_list"])
    states = [state_from_dict(load_bundle(os.path.join(
        model_path, f"{name}_face_latest.pkl"))["state"], device)
        for name in names]
    ema_net = load_motion_net(MotionNetwork(audio_extractor),
                              face_ema["umf_params"], device)
    return dict(states=states, ema_net=ema_net), names


def main(argv=None) -> dict:
    parser = make_parser("Multi-identity mouth pre-training")
    add_pretrain_args(parser)
    mc, _, oc, args = parse_all(parser, argv)
    mc.type = "mouth"
    resolve_device(args.device)     # no card: raise before reading anything
    names = (args.data_list.split(",") if args.data_list
             else face_identities(mc.model_path))
    group, dev, rank0 = start_identity_parallel(args, len(names))

    face, data_list = load_face_result(mc.model_path, names,
                                       mc.audio_extractor, dev)
    res = pretrain_mouth(mc, oc, data_list, face, seed=args.seed,
                         device=dev, identity_parallel=args.identity_parallel,
                         group=group)
    if rank0:
        save_stage(mc.model_path, "mouth", res)
        print("pretrain_mouth done")
    return res


if __name__ == "__main__":
    main()
    shutdown()
