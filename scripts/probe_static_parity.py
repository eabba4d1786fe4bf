"""Where a static step's gradients through the kernels and through plain
autograd part (on the card).

    python3 scripts/probe_static_parity.py [--size 512] [--iters 1200]
        [--frames 8] [--device cuda]

Writes a hard synthetic identity, fits it with ``train.static.train`` for
``--iters`` steps at ``ModelConfig()``'s widths, then, on each of the first
``--frames`` training views, takes one step's gradients through the
kernels and through the plain autograd composite, with D-SSIM (the
trainer's loss) and without it, and prints the worst ratio of each
gradient's difference to chip_smoke.py's tolerance, and the same ratio
when both composites are fed one cotangent: the trainer's loss gradient
with respect to the composited image, taken through the plain composite.
Beside them, per view: the largest pixel difference of the two renders,
the values whose residual against the frame is smaller than it (where
L1's gradient may take opposite signs under the two composites), the
pixels whose alpha differs by more than 1e-5 (a splat at the 1e-4
transmittance cut taken by one composite and not the other), and the
SSIM windows whose render variance (blur(x^2) - mu^2) is at most 0 under
one composite and above 0 under the other (the variance clamp then
passes a gradient in one and not the other).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from instag_torch.config import ModelConfig, OptimizationConfig  # noqa: E402
from instag_torch.data.dataset import load_frames  # noqa: E402
from instag_torch.data.synthetic_hard import generate_hard_scene  # noqa: E402
from instag_torch.device import resolve_device  # noqa: E402
from instag_torch.models import gaussians as G  # noqa: E402
from instag_torch.ops.rasterize import RasterizeConfig  # noqa: E402
from instag_torch.render import render  # noqa: E402
from instag_torch.train import static as S  # noqa: E402
from instag_torch.train.common import (build_frame_batch,  # noqa: E402
                                       gaussian_backward, rgb_loss)
from instag_torch.utils.losses import _banded  # noqa: E402

GRAD_RTOL, GRAD_ATOL_FRAC = 2e-3, 5e-4     # chip_smoke.py's


def ratio(out, ref) -> float:
    allow = GRAD_ATOL_FRAC * max(1e-6, float(ref.abs().max())) \
        + GRAD_RTOL * ref.abs()
    return float(((out - ref).abs() / allow.clamp_min(1e-30)).max())


def raw_variance(img: torch.Tensor) -> torch.Tensor:
    """blur(x^2) - blur(x)^2 of a [C, H, W] image, as ``utils.losses.ssim``
    computes it before its clamp."""
    c, h, w = img.shape
    bw = _banded(w, 11, 1.5, img.device)
    bh = _banded(h, 11, 1.5, img.device)

    def blur(x):
        y = (x.reshape(c * h, w) @ bw).reshape(c, h, w)
        return torch.einsum("ij,cjw->ciw", bh, y)
    mu = blur(img)
    return blur(img * img) - mu * mu


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--iters", type=int, default=1200)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        generate_hard_scene(tmp, n_frames=16, size=args.size, n_val=4,
                            device=dev)
        mc = ModelConfig(source_path=tmp)
        state, _, res = S.train(mc, OptimizationConfig(iterations=args.iters),
                                log_every=10 ** 9, eval_at_end=False,
                                device=dev)
        records = load_frames(tmp, "train", device=dev)
    batch = build_frame_batch(records, device=dev)
    state = state.replace(active_sh_degree=min(args.iters // 1000,
                                               state.max_sh_degree))
    print(f"fitted {args.iters} steps: {int(state.num_alive())} live of "
          f"{state.capacity}, final loss {res['final_loss']:.5f}", flush=True)

    zero = torch.zeros(3, device=dev)
    cfgs = {b: RasterizeConfig(args.size, args.size,
                               max_per_tile=mc.max_per_tile, backend=b)
            for b in ("kernel", "plain")}
    for i in range(min(args.frames, batch.num_frames)):
        worst = {}
        for lam in (0.2, 0.0):
            oc = OptimizationConfig(lambda_dssim=lam)
            g = {}
            for b, cfg in cfgs.items():
                _, _, grads, g_off = gaussian_backward(
                    S.step_loss(cfg, oc, batch, i), state, ())
                g[b] = {f: getattr(grads, f) for f in G.PARAM_FIELDS}
                g[b]["means2d_offset"] = g_off
            r = {k: ratio(g["kernel"][k], g["plain"][k]) for k in g["plain"]}
            k = max(r, key=r.get)
            worst[lam] = f"{r[k]:.3f} ({k})"
        with torch.no_grad():
            outs = {b: render(cfg, batch.camera(i), state, zero)
                    for b, cfg in cfgs.items()}
            bg = batch.bg_image(i)
            imgs = {b: o.image + bg * (1.0 - o.alpha)
                    for b, o in outs.items()}
            px = float((imgs["kernel"] - imgs["plain"]).abs().max())
            kinks = int(((imgs["plain"] - batch.gt_image(i)).abs()
                         <= px).sum())
        img = imgs["plain"].clone().requires_grad_(True)
        cot, = torch.autograd.grad(
            rgb_loss(img, batch.gt_image(i), 0.2), img)
        g = {}
        for b, cfg in cfgs.items():
            def fn(st, off, cfg=cfg):
                out = render(cfg, batch.camera(i), st, zero,
                             means2d_offset=off)
                return ((out.image + bg * (1.0 - out.alpha)) * cot).sum(), out
            _, _, grads, g_off = gaussian_backward(fn, state, ())
            g[b] = {f: getattr(grads, f) for f in G.PARAM_FIELDS}
            g[b]["means2d_offset"] = g_off
        r = {k: ratio(g["kernel"][k], g["plain"][k]) for k in g["plain"]}
        k = max(r, key=r.get)
        shared = f"{r[k]:.3f} ({k})"
        with torch.no_grad():
            alpha_px = int(((outs["kernel"].alpha - outs["plain"].alpha)
                            .abs() > 1e-5).sum())
            vk, vp = raw_variance(imgs["kernel"]), raw_variance(imgs["plain"])
            flips = int(((vk <= 0) != (vp <= 0)).sum())
            flat = int(((vk <= 0) | (vp <= 0)).sum())
        print(f"view {i}: worst gradient / tolerance with D-SSIM "
              f"{worst[0.2]}, without {worst[0.0]}, one shared cotangent "
              f"{shared}; max |pixel diff| {px:.2e}, residuals within it "
              f"{kinks}; alpha differs > 1e-5 at {alpha_px} px; SSIM "
              f"windows with variance <= 0: {flat}, of them flipped "
              f"between the composites: {flips}", flush=True)


if __name__ == "__main__":
    main()
