"""The port's brute-force splatting oracle against the JAX package's, the
port's tiled rasterizer against that oracle, and the ``cov3d_precomp``
input against the scales/rotations path and against JAX."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.ops.rasterize import rasterize as j_rasterize
from instag_tpu.ops.reference_splat import splat_reference as j_splat
from instag_torch.ops.rasterize import RasterizeConfig, rasterize
from instag_torch.ops.reference_splat import splat_reference
from instag_torch.utils.general import quat_to_rotmat, safe_normalize
from instag_torch.utils.graphics import projection_matrix, world_to_view
from tests.torch_cpu import one_torch_thread  # noqa: F401

BG = np.array([0.1, 0.2, 0.3], np.float32)


def camera(fov=0.7):
    """A camera 2 units from the origin, looking down +z (numpy)."""
    w2c = world_to_view(np.eye(3), np.array([0.0, 0.0, 2.0]))
    proj = projection_matrix(0.01, 100.0, fov, fov)
    return (w2c.T.astype(np.float32), (proj @ w2c).T.astype(np.float32),
            np.linalg.inv(w2c)[:3, 3].astype(np.float32),
            float(np.tan(fov / 2)))


def scene(n=120, seed=0, sh_deg=1, scale=(0.02, 0.03)):
    """means, opacities, scales, rotations, shs as numpy float32."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    scales = (scale[0] + scale[1] * rng.uniform(size=(n, 3))).astype(
        np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.3, 0.95, (n, 1)).astype(np.float32)
    shs = (0.3 * rng.normal(size=(n, (sh_deg + 1) ** 2, 3))).astype(
        np.float32)
    return means, opac, scales, rots, shs


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", ["sh0", "sh1", "colors_precomp", "bbox4"])
def test_oracle_matches_jax(case):
    H = W = 48
    sh_deg = 0 if case == "sh0" else 1
    means, opac, scales, rots, shs = scene(n=80, sh_deg=sh_deg)
    view, full, campos, tanfov = camera()
    kw = dict(sh_degree=sh_deg)
    if case == "colors_precomp":
        colors = np.random.default_rng(1).uniform(size=(80, 3)).astype(
            np.float32)
        j_kw, t_kw = ({"colors_precomp": jnp.asarray(colors)},
                      {"colors_precomp": torch.from_numpy(colors)})
    else:
        j_kw, t_kw = ({"shs": jnp.asarray(shs), **kw},
                      {"shs": torch.from_numpy(shs), **kw})
    if case == "bbox4":
        j_kw["bbox_sigma"] = t_kw["bbox_sigma"] = 4.0
    ref = j_splat(JConfig(H, W, max_per_tile=160, approx_topk=False),
                  *map(jnp.asarray, (means, opac, scales, rots, view, full,
                                     campos)), tanfov, tanfov,
                  jnp.asarray(BG), **j_kw)
    out = splat_reference(RasterizeConfig(H, W, max_per_tile=160),
                          *_torch(means, opac, scales, rots, view, full,
                                  campos), tanfov, tanfov,
                          torch.from_numpy(BG), **t_kw)
    for name, o, r in zip(("image", "depth", "normal", "alpha"), out, ref):
        assert o.dtype == torch.float64 and tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5,
                                   err_msg=name)


def test_oracle_box_is_exact():
    """A 4-sigma box skips only pixels the 1/255 alpha floor skips."""
    H = W = 48
    means, opac, scales, rots, shs = scene(n=80)
    view, full, campos, tanfov = camera()
    args = (RasterizeConfig(H, W), *_torch(means, opac, scales, rots, view,
                                           full, campos), tanfov, tanfov,
            torch.from_numpy(BG))
    kw = dict(shs=torch.from_numpy(shs), sh_degree=1)
    for a, b in zip(splat_reference(*args, **kw),
                    splat_reference(*args, **kw, bbox_sigma=4.0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("sh_deg", [0, 1, 2])
def test_rasterize_matches_oracle(backend, sh_deg):
    """The tiled rasterizer (on the CPU its kernels' plain versions, or the
    autograd composite) under the JAX suite's own oracle bounds."""
    H = W = 64
    cfg = RasterizeConfig(H, W, max_per_tile=160, backend=backend)
    means, opac, scales, rots, shs = _torch(*scene(n=120, sh_deg=sh_deg))
    view, full, campos, tanfov = camera()
    view, full, campos = _torch(view, full, campos)
    bg = torch.from_numpy(BG)
    out = rasterize(cfg, means, opac, scales, rots, view, full, campos,
                    tanfov, tanfov, bg, shs=shs, sh_degree=sh_deg)
    img, dep, nrm, alp = splat_reference(cfg, means, opac, scales, rots,
                                         view, full, campos, tanfov, tanfov,
                                         bg, shs=shs, sh_degree=sh_deg,
                                         bbox_sigma=4.0)
    for name, o, r, atol in (("image", out.image, img, 2e-3),
                             ("alpha", out.alpha, alp, 2e-3),
                             ("depth", out.depth, dep, 2e-2),
                             ("normal", out.normal, nrm, 5e-3)):
        np.testing.assert_allclose(o.detach().numpy(), r.numpy(), atol=atol,
                                   err_msg=name)


@pytest.fixture(scope="module")
def jax_refs():
    """JAX references a test's kernel and plain cases share: traced once."""
    return {}


def _cov6(scales, rots):
    """R S^2 R^T as (c00, c01, c02, c11, c12, c22) [N, 6]."""
    R = quat_to_rotmat(safe_normalize(torch.from_numpy(rots))).double()
    s2 = torch.from_numpy(scales).double() ** 2
    sig = torch.einsum("nij,nj,nkj->nik", R, s2, R)
    return torch.stack([sig[:, 0, 0], sig[:, 0, 1], sig[:, 0, 2],
                        sig[:, 1, 1], sig[:, 1, 2], sig[:, 2, 2]], 1).float()


def test_cov3d_precomp_matches_scales_rotations():
    H = W = 32
    cfg = RasterizeConfig(H, W, max_per_tile=64)
    means, opac, scales, rots, shs = scene(n=60)
    view, full, campos, tanfov = camera()
    args = (cfg, *_torch(means, opac, scales, rots, view, full, campos),
            tanfov, tanfov, torch.tensor([0.05, 0.1, 0.15]))
    kw = dict(shs=torch.from_numpy(shs), sh_degree=1)
    out_sr = rasterize(*args, **kw)
    out_cv = rasterize(*args, **kw, cov3d_precomp=_cov6(scales, rots))
    np.testing.assert_allclose(out_cv.image.numpy(), out_sr.image.numpy(),
                               atol=1e-5)
    assert torch.equal(out_cv.radii, out_sr.radii)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_cov3d_precomp_image_and_gradient_match_jax(backend, jax_refs):
    H = W = 32
    means, opac, scales, rots, shs = scene(n=60, seed=3)
    view, full, campos, tanfov = camera()
    cov6 = _cov6(scales, rots).numpy()
    weights = np.random.default_rng(4).normal(size=(3, H, W)).astype(
        np.float32)
    bg = np.array([0.05, 0.1, 0.15], np.float32)

    def j_loss(c):
        out = j_rasterize(JConfig(H, W, max_per_tile=64, approx_topk=False),
                          *map(jnp.asarray, (means, opac, scales, rots, view,
                                             full, campos)), tanfov, tanfov,
                          jnp.asarray(bg), shs=jnp.asarray(shs), sh_degree=1,
                          cov3d_precomp=c)
        return jnp.sum(out.image * weights), out.image

    if "cov3d" not in jax_refs:
        jax_refs["cov3d"] = jax.device_get(jax.jit(jax.value_and_grad(
            j_loss, has_aux=True))(jnp.asarray(cov6)))
    (_, j_img), j_grad = jax_refs["cov3d"]
    c = torch.from_numpy(cov6).requires_grad_(True)
    out = rasterize(RasterizeConfig(H, W, max_per_tile=64, backend=backend),
                    *_torch(means, opac, scales, rots, view, full, campos),
                    tanfov, tanfov, torch.from_numpy(bg),
                    shs=torch.from_numpy(shs), sh_degree=1,
                    cov3d_precomp=c)
    (out.image * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(out.image.detach().numpy(), np.asarray(j_img),
                               rtol=1e-4, atol=1e-6)
    j_grad = np.asarray(j_grad)
    assert np.abs(j_grad).max() > 0
    np.testing.assert_allclose(c.grad.numpy(), j_grad, rtol=1e-4,
                               atol=1e-4 * np.abs(j_grad).max())
