"""Where the port's pre-training parts from the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python scripts/probe_pretrain_parity.py [--loops]

On the two generated 64x64 identities of tests/test_torch_pretrain_face.py
(written to a temporary directory), the script prints:
  * both packages' SSIM of one same pair of images, the mouth step's
    render and its painted target, with and without the hair painted
    green: the relative difference, and the share of the loss it makes;
  * how far the port's face motion step's gradients move when the
    rendered pixels that are not background move by 1e-7, with the D-SSIM
    term and without it, as a multiple of the kernel-check tolerance of
    chip_smoke.py (rtol 2e-3 on top of 5e-4 of each tensor's largest);
  * with ``--loops``: the port's and JAX's EMA after the test's
    30-step-an-identity ``pretrain_face``, as the L2 distance over every
    parameter over how far JAX's EMA moved from the start, beside the same
    figure for two JAX runs whose starting UMFs differ by one part in 1e6.
A test-side tool: the port itself imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import tests.conftest  # noqa: E402,F401  (JAX on the CPU)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import tests.test_torch_pretrain_face as T  # noqa: E402
from instag_tpu.data.synthetic import generate_scene  # noqa: E402
from instag_tpu.utils.losses import ssim as j_ssim  # noqa: E402
from instag_torch import render as R  # noqa: E402
from instag_torch.models import gaussians as G  # noqa: E402
from instag_torch.train import pretrain as P  # noqa: E402
from instag_torch.train.common import rect_mask  # noqa: E402
from instag_torch.utils.losses import ssim as t_ssim  # noqa: E402

GRAD_RTOL, GRAD_ATOL_FRAC = 2e-3, 5e-4     # chip_smoke.py's
GREEN = torch.tensor([0.0, 1.0, 0.0])[:, None, None]


def ssim_gap(tb, frame: int) -> None:
    state = T.state_from_jax(T.step_cloud(21, mouth=True), "cpu")
    face = T.state_from_jax(T.step_cloud(22), "cpu")
    rng = np.random.default_rng(23)
    umf, (pmf,) = T.port_nets("mouth", T.flax_tree(
        T.TM.MouthMotionNetwork(), rng), [T.flax_tree(
            T.TM.PersonalizedMotionNetwork("mouth"), rng)])
    face_net = T.load_motion_net(T.TM.MotionNetwork(), T.flax_tree(
        T.TM.MotionNetwork(), rng), "cpu")
    with torch.no_grad():
        out = R.render_motion_mouth(
            T.RasterizeConfig(T.SIZE, T.SIZE, max_per_tile=T.K),
            tb.camera(frame), state, mouth_umf=umf, face_state=face,
            face_umf=face_net, aud=tb.auds[frame], bg=GREEN[:, 0, 0],
            pmf=pmf, personalized=True, align=False).out
    mouth = tb.mouth_mask[frame]
    band = rect_mask(T.SIZE, T.SIZE, tb.lips_rect[frame]) ^ mouth
    img = torch.where(band[None], GREEN, out.image)
    gt = torch.where(mouth[None], tb.gt_image(frame), GREEN)
    hair = tb.hair_mask[frame][None]
    for label, (a, b) in (("mouth step pair", (img, gt)), (
            "with the hair painted", (torch.where(hair, GREEN, img),
                                      torch.where(hair, GREEN, gt)))):
        jv = float(j_ssim(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
        tv = float(t_ssim(a, b))
        loss = float((a - b).abs().mean() + 0.2 * (1 - tv))
        print(f"SSIM, {label}: JAX {jv:.8f}, port {tv:.8f}: "
              f"{abs(jv - tv) / abs(jv):.2e} relative, "
              f"{0.2 * abs(jv - tv) / loss:.2e} of the loss")


def noise_gain(tb, extent: float, frame: int) -> None:
    state = T.state_from_jax(T.JG.create_from_points(
        *map(jnp.asarray, T.random_init_points(300, 3)), 1024, 2, 1.0),
        "cpu")
    rng = np.random.default_rng(12)
    umf_p = T.flax_tree(T.TM.MotionNetwork(), rng)
    pmf_p = [T.flax_tree(T.TM.PersonalizedMotionNetwork("face"), rng)
             for _ in T.IDS]
    real = R.render_motion

    def noisy(*args, **kw):
        mr = real(*args, **kw)
        img = mr.out.image
        noise = 1e-7 * torch.randn(
            img.shape, generator=torch.Generator().manual_seed(0))
        return mr._replace(out=mr.out._replace(
            image=img + noise * (img != GREEN)))

    for lam in (0.2, 0.0):
        grads = []
        for fn in (real, noisy):
            P.render_motion = fn
            umf, pmfs = T.port_nets("face", umf_p, pmf_p)
            step = P.make_pretrain_face_step(
                T.RasterizeConfig(T.SIZE, T.SIZE, max_per_tile=T.K),
                T.OptimizationConfig(lambda_dssim=lam), umf, pmfs,
                copy.deepcopy(umf), extent, 1, 60, device="cpu")
            _, _, g, _ = step.loss_and_grads(state, 0, tb, frame,
                                             P.PretrainFlags(1.0, 0.0))
            d = {f: getattr(g, f) for f in G.PARAM_FIELDS}
            d.update({n: p.grad.clone() for n, p in umf.named_parameters()})
            grads.append(d)
        P.render_motion = real
        worst = max(float(((grads[1][n] - b).abs() / (
            GRAD_RTOL * b.abs() + GRAD_ATOL_FRAC * b.abs().max()
        ).clamp_min(1e-30)).max()) for n, b in grads[0].items())
        print(f"face step, lambda_dssim {lam}: a 1e-7 change of the "
              f"rendered pixels moves the gradients by {worst:.3g}x the "
              f"kernel-check tolerance")


def ema_parting(root: str) -> None:
    mc = T.model_configs(root)[0]
    ref = jax.device_get(T.JP.pretrain_face(
        mc, T.JOptConfig(**T.LOOP_OPT), T.IDS, **T.LOOP_KW))
    umf_p, pmf_p = T.jax_start_nets("face", 0, len(T.IDS))
    start = T.motion_state_dict(umf_p)
    ours = T.port_pretrain_face(root, umf_p, pmf_p)
    print(f"EMA, port against JAX: "
          f"{T.ema_parting(ours['ema_net'], ref['ema_params'], start):.4f} "
          f"of JAX's movement")
    init = T.JM.MotionNetwork.init

    def nudged(self, *args, **kw):
        return jax.tree.map(lambda x: x * (1 + 1e-6), init(self, *args,
                                                           **kw))
    T.JM.MotionNetwork.init = nudged
    try:
        other = jax.device_get(T.JP.pretrain_face(
            mc, T.JOptConfig(**T.LOOP_OPT), T.IDS, **T.LOOP_KW))
    finally:
        T.JM.MotionNetwork.init = init
    ema = T.load_motion_net(T.TM.MotionNetwork(), other["ema_params"],
                            "cpu")
    print(f"EMA, JAX against JAX from a UMF 1e-6 apart: "
          f"{T.ema_parting(ema, ref['ema_params'], start):.4f} of its "
          f"movement")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--loops", action="store_true")
    args = parser.parse_args()
    torch.set_num_threads(2)
    with tempfile.TemporaryDirectory() as root:
        for k, name in enumerate(T.IDS):
            generate_scene(os.path.join(root, name), n_frames=6,
                           size=T.SIZE, n_val=2, seed=k, variation=0.3)
        _, tb, extent = T.identity_batch(root, T.IDS[0])
        ssim_gap(tb, 3)
        noise_gain(tb, extent, 2)
        if args.loops:
            ema_parting(root)


if __name__ == "__main__":
    main()
