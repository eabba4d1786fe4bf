"""CLI: fused synthesis of a clip (counterpart of
instag_tpu/cli/synthesize_fuse.py).

    python -m instag_torch.cli.synthesize_fuse -m output/<run> -s data/<id> \
        [--use_train] [--audio feats.npy] [--dilate] [--personalized] \
        [--fast] [--select_every k | --select_auto [px]] [--mux_audio] \
        [--device cuda]

Reads ``<model_path>/chkpnt_fuse_latest.pkl`` (either package's fuse
bundle) and, when present, ``source_path``, ``audio_extractor`` and
``max_per_tile`` from ``<model_path>/cfg_args.json``; writes
``<model_path>/out.mp4`` (or ``out.mp4.frames.npz`` without OpenCV).
"""

from __future__ import annotations

import os

import torch

from ..config import load_cfg, make_parser, parse_all
from ..device import resolve_device
from ..io.checkpoints import load_bundle, state_from_dict
from ..io.from_jax import load_motion_net
from ..models.motion import (MotionNetwork, MouthMotionNetwork,
                             PersonalizedMotionNetwork)
from ..synthesize import SynthesisModel, synthesize


def load_fuse_model(path: str, audio_extractor: str = "deepspeech",
                    device: str | torch.device = "cuda") -> SynthesisModel:
    """A fuse bundle (``face_state``, ``mouth_state`` and the four motion
    networks' flax trees) as the port's SynthesisModel on ``device``."""
    dev = resolve_device(device)
    bundle = load_bundle(path)
    nets = dict(face_umf=MotionNetwork(audio_extractor),
                mouth_umf=MouthMotionNetwork(audio_extractor),
                face_pmf=PersonalizedMotionNetwork("face", audio_extractor),
                mouth_pmf=PersonalizedMotionNetwork("mouth",
                                                    audio_extractor))
    return SynthesisModel(
        face_state=state_from_dict(bundle["face_state"], dev),
        mouth_state=state_from_dict(bundle["mouth_state"], dev),
        **{k: load_motion_net(net, bundle[f"{k}_params"], dev)
           for k, net in nets.items()})


def build_parser():
    parser = make_parser("Fused synthesis")
    parser.add_argument("--use_train", action="store_true")
    parser.add_argument("--dilate", action="store_true")
    parser.add_argument("--personalized", action="store_true")
    parser.add_argument("--fast", action="store_true")
    parser.add_argument("--select_every", type=int, default=1,
                        help="select each tile's splats afresh only every "
                             "k-th frame and reuse the lists in between (1: "
                             "every frame; must divide the chunk of 4)")
    parser.add_argument("--select_auto", type=float, default=0.0,
                        nargs="?", const=4.0,
                        help="reuse each branch's selection until a splat "
                             "moved more than this many pixels since it was "
                             "made (bare flag: 4.0, a quarter tile); "
                             "exclusive with --select_every")
    parser.add_argument("--mux_audio", action="store_true",
                        help="attach the tail of the scene's aud.wav: an "
                             "ffmpeg remux when ffmpeg is present, else an "
                             "MJPEG + PCM AVI beside out.mp4")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    mc, _, _, args = parse_all(build_parser(), argv)
    if os.path.exists(os.path.join(mc.model_path, "cfg_args.json")):
        saved = load_cfg(mc.model_path)
        if not mc.source_path:
            mc.source_path = saved.source_path
        mc.audio_extractor = saved.audio_extractor
        mc.max_per_tile = saved.max_per_tile

    dev = resolve_device(args.device)
    model = load_fuse_model(
        os.path.join(mc.model_path, "chkpnt_fuse_latest.pkl"),
        mc.audio_extractor, dev)
    out = os.path.join(mc.model_path, "out.mp4")
    video, fps = synthesize(
        mc, model, split="train" if args.use_train else "val",
        audio_file=mc.audio, dilate=args.dilate,
        personalized=args.personalized, out_path=out,
        dump_plys=0 if args.fast else 11,
        ply_dir=os.path.join(mc.model_path, "deformed_ply"), fast=args.fast,
        select_every=args.select_every, select_auto=args.select_auto,
        device=dev)
    print(f"synthesized {video.shape[0]} frames @ {fps:.1f} FPS on {dev}")

    if args.mux_audio:
        from ..io.avmux import mux_audio
        dst = mux_audio(out, video, 25.0,
                        os.path.join(mc.source_path, "aud.wav"), device=dev)
        if dst:
            print(f"wrote {dst} (with audio)")


if __name__ == "__main__":
    main()
