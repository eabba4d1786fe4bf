"""CLI: multi-identity face UMF pre-training (counterpart of
instag_tpu/cli/pretrain_face.py).

    python -m instag_torch.cli.pretrain_face -s data/pretrain \
        -m output/pretrain --init_num 2000 --iterations 30000 \
        [--data_list id_a,id_b,id_c] [--share_audio_net] [--seed 0] \
        [--device cuda]

Each identity is a scene directory under ``--source_path`` (all of its
subdirectories by default). Writes the JAX CLI's bundles, which either
package reads: ``chkpnt_face_latest.pkl`` (the UMF and ``data_list``),
``chkpnt_ema_face_latest.pkl`` (its EMA as ``umf_params`` and
``ema_params``; what ``train_face --pretrain_path`` and ``adapt
--pretrain_path`` read), ``<identity>_face_latest.pkl`` (the identity's
cloud and PMF, which ``pretrain_mouth`` reads) and ``cfg_args.json``.
"""

from __future__ import annotations

import os

from ..config import make_parser, parse_all, save_cfg
from ..device import resolve_device
from ..io.checkpoints import flax_params, save_bundle, state_to_dict
from ..train.pretrain import pretrain_face


def add_pretrain_args(parser) -> None:
    """The flags every pre-training CLI shares."""
    parser.add_argument("--data_list", type=str, default="",
                        help="comma-separated identity directories under "
                             "source_path; default: all of them")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--identity_parallel", action="store_true",
                        help="one device per identity; the port has no "
                             "device mesh and refuses it")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")


def check_identity_parallel(on: bool) -> None:
    if on:
        raise SystemExit(
            "--identity_parallel: training every identity at once needs a "
            "device mesh of one card an identity, which the port does not "
            "have yet (ROADMAP queue 1, item 7); run without it for the "
            "serial path")


def identity_list(source_path: str, data_list: str) -> list[str]:
    """``--data_list`` split at commas, else every directory under
    ``source_path``, sorted."""
    if data_list:
        return data_list.split(",")
    return sorted(d for d in os.listdir(source_path)
                  if os.path.isdir(os.path.join(source_path, d)))


def save_stage(model_path: str, branch: str, res: dict) -> None:
    """The UMF and EMA bundles of a pre-training result, as the JAX CLIs
    write them."""
    data_list = res["data_list"]
    ema = flax_params(res["ema_net"])
    save_bundle(os.path.join(model_path, f"chkpnt_{branch}_latest.pkl"),
                dict(umf_params=flax_params(res["umf_net"]),
                     data_list=data_list))
    save_bundle(os.path.join(model_path, f"chkpnt_ema_{branch}_latest.pkl"),
                dict(umf_params=ema, ema_params=ema, data_list=data_list))


def save_identities(model_path: str, res: dict) -> None:
    """Each identity's face cloud and PMF (``<identity>_face_latest.pkl``);
    with ``share_audio_net`` a PMF's audio weights are the UMF's."""
    for name, state, pmf in zip(res["data_list"], res["states"],
                                res["pmf_nets"]):
        save_bundle(os.path.join(model_path, f"{name}_face_latest.pkl"),
                    dict(state=state_to_dict(state),
                         pmf_params=flax_params(pmf)))


def main(argv=None) -> dict:
    parser = make_parser("Multi-identity face pre-training")
    parser.add_argument("--share_audio_net", action="store_true",
                        help="tie every PMF's audio encoder to the UMF's")
    add_pretrain_args(parser)
    mc, _, oc, args = parse_all(parser, argv)
    mc.type = "face"
    check_identity_parallel(args.identity_parallel)
    dev = resolve_device(args.device)

    res = pretrain_face(mc, oc, identity_list(mc.source_path, args.data_list),
                        seed=args.seed, share_audio_net=args.share_audio_net,
                        device=dev)
    save_cfg(mc.model_path, mc)
    save_stage(mc.model_path, "face", res)
    save_identities(mc.model_path, res)
    print("pretrain_face done")
    return res


if __name__ == "__main__":
    main()
