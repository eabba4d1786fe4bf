"""Compare a clip of the PyTorch port with the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python scripts/compare_clip_with_jax.py \
        --model <run> --scene <scene> [--card_frames frames.npz]

``<run>`` holds ``chkpnt_fuse_latest.pkl`` and ``cfg_args.json`` (as
``chip_smoke.py`` phase 12 writes them), ``<scene>`` a scene directory.
Both packages synthesize the val split on the CPU in the exact,
``select_every 4`` and ``select_auto 4.0`` modes; the script prints, per
mode, the largest level difference and the share of differing values
between the two packages' frames, each package's PSNR against its own
exact clip, the refresh lines, and, with ``--card_frames`` (an ``.npz``
of the port's clips on the card under the keys exact, every4 and auto4),
the card's frames against the port's CPU frames. A test-side tool: the
port itself imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MODES = {"exact": {}, "every4": {"select_every": 4},
         "auto4": {"select_auto": 4.0}}


def psnr(a, b) -> float:
    err = (a.astype(np.float64) - b) / 255.0
    return float(-10 * np.log10((err ** 2).mean() + 1e-12))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", required=True)
    ap.add_argument("--scene", required=True)
    ap.add_argument("--card_frames", default="")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    from instag_tpu.config import load_cfg as j_load_cfg
    from instag_tpu.io.checkpoints import load_bundle, state_from_dict
    from instag_tpu.synthesize import synthesize as j_synthesize
    from instag_torch.cli.synthesize_fuse import load_fuse_model
    from instag_torch.config import load_cfg
    from instag_torch.synthesize import synthesize

    path = os.path.join(args.model, "chkpnt_fuse_latest.pkl")
    j_cfg, t_cfg = j_load_cfg(args.model), load_cfg(args.model)
    j_cfg.source_path = t_cfg.source_path = args.scene
    bundle = load_bundle(path)
    for k in ("face_state", "mouth_state"):
        bundle[k] = state_from_dict(bundle[k])
    model = load_fuse_model(path, t_cfg.audio_extractor, "cpu")
    card = np.load(args.card_frames) if args.card_frames else None

    clips, out = {}, {}
    for mode, kw in MODES.items():
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            j_video, _ = j_synthesize(j_cfg, bundle, split="val",
                                      out_path=None, **kw)
            t_video, _ = synthesize(t_cfg, model, split="val", out_path=None,
                                    device="cpu", **kw)
        j_video = np.asarray(j_video)
        clips[mode] = (j_video, t_video)
        diff = np.abs(j_video.astype(int) - t_video)
        out[mode] = dict(jax_vs_port_max_level=int(diff.max()),
                         jax_vs_port_share=float((diff > 0).mean()),
                         log=log.getvalue().strip().splitlines())
        if card is not None:
            cdiff = np.abs(card[mode].astype(int) - t_video)
            out[mode].update(card_vs_port_cpu_max_level=int(cdiff.max()),
                             card_vs_port_cpu_share=float((cdiff > 0).mean()))
    for mode in ("every4", "auto4"):
        out[mode]["jax_psnr_vs_exact"] = psnr(clips[mode][0],
                                              clips["exact"][0])
        out[mode]["port_psnr_vs_exact"] = psnr(clips[mode][1],
                                               clips["exact"][1])
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
