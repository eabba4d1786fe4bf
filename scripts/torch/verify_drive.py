"""The PyTorch/CUDA port's counterpart of scripts/verify_drive.py: its drive
recipe on instag_torch, runnable. A fit
through ``render`` whose PSNR must climb by more than 5 dB (through a
``keep_slots`` grow half way), the all-behind-camera probe (radii all 0,
the image equal to the background) and the hash-grid out-of-bounds probe
(zero features, finite gradients).

    python scripts/torch/verify_drive.py [--device cuda]

On the card (the default) the fit's renders and backwards launch the
three kernels (``composite_fwd``, ``composite_bwd``, ``scatter_add``);
``--device cpu`` runs their plain versions. Runs from any directory."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from instag_torch.device import resolve_device  # noqa: E402
from instag_torch.models import gaussians as G  # noqa: E402
from instag_torch.ops.hashgrid import (HashGridConfig,  # noqa: E402
                                       hashgrid_encode, init_hashgrid)
from instag_torch.ops.rasterize import RasterizeConfig  # noqa: E402
from instag_torch.render import Camera, render  # noqa: E402
from instag_torch.utils.graphics import (projection_matrix,  # noqa: E402
                                         world_to_view)
from instag_torch.utils.losses import psnr  # noqa: E402

H = W = 64
PSNR_GAIN = 5.0          # dB the fit must climb


def camera(dev: torch.device) -> Camera:
    """The recipe's camera: 2 units back on the z axis, 0.8 rad fields."""
    w2v = world_to_view(np.eye(3), np.array([0, 0, 2.0]))
    proj = projection_matrix(0.01, 100.0, 0.8, 0.8) @ w2v
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32),  # noqa: E731
                                 device=dev)
    return Camera(f32(w2v.T), f32(proj.T), f32(np.linalg.inv(w2v)[:3, 3]),
                  f32(np.tan(0.4)), f32(np.tan(0.4)))


def cloud(rng, n: int, capacity: int, dev: torch.device, spread=0.2,
          centre=(0.0, 0.0, 0.0), colors=None) -> G.GaussianState:
    pts = rng.normal(size=(n, 3)) * spread + np.asarray(centre)
    cols = rng.uniform(0.2, 1, (n, 3)) if colors is None else colors
    return G.create_from_points(
        torch.tensor(pts, dtype=torch.float32, device=dev),
        torch.tensor(cols, dtype=torch.float32, device=dev), capacity, 0,
        1.0)


def fit(dev: torch.device, steps: int = 75) -> tuple[float, float]:
    """A 200-splat cloud fitted to another's render with Adam, ``steps``
    steps, a ``keep_slots`` grow from 256 to 512 slots (which must leave
    the render as it was), ``steps`` more; returns the PSNR before and
    after."""
    rng = np.random.default_rng(0)
    cfg, cam = RasterizeConfig(H, W), camera(dev)
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        target = render(cfg, cam, cloud(rng, 200, 256, dev), bg).image
    st = cloud(rng, 200, 256, dev)
    opt = G.adam_init(st.params)
    lrs = {k: 0.01 if k == "xyz" else 0.02 for k in G.PARAM_FIELDS}

    def score(s):
        with torch.no_grad():
            return float(psnr(render(cfg, cam, s, bg).image, target))

    def step(st, opt):
        leaves = G.GaussianParams(**{
            n: getattr(st.params, n).detach().requires_grad_(True)
            for n in G.PARAM_FIELDS})
        loss = (render(cfg, cam, st.replace(params=leaves), bg).image
                - target).abs().mean()
        loss.backward()
        # a field the render does not reach (the SH rest at degree 0, the
        # identity) gets a zero gradient, as jax.grad gives it
        grads = G.GaussianParams(**{
            n: torch.zeros_like(p) if p.grad is None else p.grad
            for n, p in ((n, getattr(leaves, n)) for n in G.PARAM_FIELDS)})
        params, opt = G.adam_update(st.params, grads, opt, lrs, st.alive)
        return st.replace(params=params), opt

    p0 = score(st)
    for _ in range(steps):
        st, opt = step(st, opt)
    mid = score(st)
    st, opt = G.pack_resize(st, opt, 512, keep_slots=True)
    if not abs(score(st) - mid) < 1e-6:
        raise AssertionError("keep_slots resize changed the render")
    for _ in range(steps):
        st, opt = step(st, opt)
    return p0, score(st)


def behind_camera_probe(dev: torch.device) -> None:
    """A cloud wholly behind the camera projects nothing: radii all 0 and
    the image the (black) background."""
    rng = np.random.default_rng(1)
    behind = cloud(rng, 50, 64, dev, spread=0.1, centre=(0, 0, -10.0),
                   colors=np.full((50, 3), 0.5))
    with torch.no_grad():
        out = render(RasterizeConfig(H, W), camera(dev), behind,
                     torch.zeros(3, device=dev))
    if not (int(out.radii.max()) == 0 and float(out.image.abs().max()) == 0):
        raise AssertionError("a cloud behind the camera reached the image")


def hashgrid_oob_probe(dev: torch.device) -> None:
    """Inputs outside the grid's bounds encode to zeros, and the table's
    gradient through in-bounds inputs is finite."""
    hcfg = HashGridConfig(input_dim=2, num_levels=4, level_dim=2)
    emb = init_hashgrid(hcfg, torch.Generator(dev).manual_seed(0))
    feats = hashgrid_encode(hcfg, emb, torch.full((8, 2), 5.0, device=dev))
    if float(feats.abs().max()) != 0.0:
        raise AssertionError("out-of-bounds inputs gave non-zero features")
    emb = emb.requires_grad_(True)
    hashgrid_encode(hcfg, emb, torch.zeros((8, 2), device=dev)).sum() \
        .backward()
    if not bool(torch.isfinite(emb.grad).all()):
        raise AssertionError("non-finite hash-grid gradient")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    p0, p1 = fit(dev)
    print(f"fit: PSNR {p0:.2f} -> {p1:.2f} dB (through keep_slots grow)")
    if not p1 > p0 + PSNR_GAIN:
        raise AssertionError(f"the fit climbed {p1 - p0:.2f} dB, not "
                             f"{PSNR_GAIN}")
    behind_camera_probe(dev)
    print("behind-camera probe OK")
    hashgrid_oob_probe(dev)
    print("hashgrid OOB probe OK")
    print("VERIFY DRIVE PASSED")
    return dict(psnr_before=p0, psnr_after=p1)


if __name__ == "__main__":
    main()
