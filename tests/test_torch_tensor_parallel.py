"""The port's tensor-parallel rendering
(``instag_torch/parallel/tensor_parallel.py``) against its single-process
rasterizer and the JAX package's ``rasterize_tensor_parallel``, on
``tests/test_tensor_parallel.py``'s scene (500 splats in 1024 slots, SH
degree 1) and cases: 4 ranks at 64x64 and 2 at 96x72 (one spawn of 4
gloo ranks, the 2-rank case on a subgroup, under its own time limit).
Each rank's image, depth, normal and alpha band and its splats' radii,
and at 64x64 each rank's gradients of its splats' positions, opacities
and screen offsets for ``sum(image^2) + sum(alpha)``, match both within
that file's tolerances; ``band_config`` refuses a band count that does
not divide the tile rows.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from instag_torch.ops.rasterize import RasterizeConfig, rasterize
from instag_torch.parallel.launch import start
from instag_torch.parallel.tensor_parallel import (band_config,
                                                   rasterize_tensor_parallel)
from tests.torch_cpu import one_torch_thread  # noqa: F401

CASES = [(4, 64, 64), (2, 96, 72)]
GRAD_CASE = (4, 64, 64)
K = 64
IMAGES = {"image": 3e-5, "alpha": 3e-5, "depth": 3e-4, "normal": 3e-5}


def _scene_np(H, W):
    """``tests/test_tensor_parallel.py``'s ``_scene`` as numpy."""
    from tests.test_tensor_parallel import _scene
    return {k: (np.asarray(v) if hasattr(v, "shape") else v)
            for k, v in _scene(H, W).items()}


def _torch_args(a):
    out = {}
    for k, v in a.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.array(v))
            out[k] = v if v.ndim else v.reshape(())
        else:
            out[k] = v
    return out


def _grads(cfg, a, render):
    """(outputs, grads of xyz, opacities, offsets) of the loss over what
    ``render`` returns."""
    xyz = a["means3d"].clone().requires_grad_(True)
    opac = a["opacities"].clone().requires_grad_(True)
    off = torch.zeros((xyz.shape[0], 2), requires_grad=True)
    out = render(dict(a, means3d=xyz, opacities=opac, means2d_offset=off))
    (out.image.pow(2).sum() + out.alpha.sum()).backward()
    return out, (xyz.grad, opac.grad, off.grad)


def _rank_work(rank, group, dev, scenes):
    torch.set_num_threads(1)
    res = {}
    sub = dist.new_group([0, 1])
    for (w, H, W), a in scenes.items():
        g = group if w == 4 else sub
        if rank >= w:
            continue
        cfg = RasterizeConfig(H, W, max_per_tile=K)
        a = _torch_args(a)
        n = a["means3d"].shape[0] // w
        rows = slice(rank * n, (rank + 1) * n)
        mine = {k: (v[rows] if isinstance(v, torch.Tensor) and v.ndim
                    and v.shape[0] == 1024 else v) for k, v in a.items()}

        def render(b):
            return rasterize_tensor_parallel(cfg, g, **b)
        if (w, H, W) == GRAD_CASE:
            out, grads = _grads(cfg, mine, render)
            res[(w, H, W, "grads")] = [x.numpy() for x in grads]
        else:
            with torch.no_grad():
                out = render(mine)
        res[(w, H, W)] = {k: getattr(out, k).detach().numpy()
                          for k in ("image", "alpha", "depth", "normal",
                                    "radii")}
    return res


@pytest.fixture(scope="module")
def scenes():
    return {c: _scene_np(c[1], c[2]) for c in CASES}


@pytest.fixture(scope="module")
def ranks(scenes):
    handle = start(_rank_work, 4, (scenes,), device="cpu", timeout=240.0)
    yield handle
    handle.join()


@pytest.fixture(scope="module")
def jax_refs(scenes, ranks):
    """JAX's tensor-parallel outputs (the virtual CPU devices) and its
    gradients at ``GRAD_CASE``."""
    import jax
    import jax.numpy as jnp
    from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
    from instag_tpu.parallel.tensor_parallel import (
        rasterize_tensor_parallel as j_tp)
    from tests.test_tensor_parallel import _mesh, _scene
    refs = {}
    for w, H, W in CASES:
        cfg = JConfig(H, W, max_per_tile=K, approx_topk=False,
                      backend="xla")
        args = _scene(H, W)
        mesh = _mesh(w)
        arrays = {k: v for k, v in args.items() if k != "sh_degree"}
        out = jax.jit(lambda a: j_tp(cfg, mesh, sh_degree=1, **a))(arrays)
        refs[(w, H, W)] = {k: np.asarray(getattr(out, k)) for k in (
            "image", "alpha", "depth", "normal", "radii")}
        if (w, H, W) == GRAD_CASE:
            def loss(xyz, opac, off):
                o = j_tp(cfg, mesh, **dict(args, means3d=xyz, opacities=opac,
                                           means2d_offset=off))
                return jnp.sum(o.image ** 2) + jnp.sum(o.alpha)
            n = args["means3d"].shape[0]
            g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
                args["means3d"], args["opacities"],
                jnp.zeros((n, 2), jnp.float32))
            refs[(w, H, W, "grads")] = [np.asarray(x) for x in g]
    return refs


def _bands(outs, case):
    w = case[0]
    return {k: (np.concatenate([outs[r][case][k] for r in range(w)],
                               axis=0 if k == "radii" else 1))
            for k in ("image", "alpha", "depth", "normal", "radii")}


def _check(ours, ref):
    for k, atol in IMAGES.items():
        np.testing.assert_allclose(ours[k], ref[k], atol=atol, rtol=1e-4,
                                   err_msg=k)
    np.testing.assert_array_equal(ours["radii"], ref["radii"])


@pytest.mark.parametrize("case", CASES)
def test_bands_match_single_and_jax(case, scenes, ranks, jax_refs):
    w, H, W = case
    outs = ranks.join()
    ours = _bands(outs, case)
    assert ours["image"].shape == (3, H, W)
    a = _torch_args(scenes[case])
    with torch.no_grad():
        single = rasterize(RasterizeConfig(H, W, max_per_tile=K), **a)
    _check(ours, {k: getattr(single, k).numpy() for k in ours})
    _check(ours, jax_refs[case])


def test_gradients_match_single_and_jax(scenes, ranks, jax_refs):
    w, H, W = GRAD_CASE
    outs = ranks.join()
    ours = [np.concatenate([outs[r][GRAD_CASE + ("grads",)][i]
                            for r in range(w)]) for i in range(3)]
    a = _torch_args(scenes[GRAD_CASE])
    _, single = _grads(RasterizeConfig(H, W, max_per_tile=K), a,
                       lambda b: rasterize(RasterizeConfig(
                           H, W, max_per_tile=K), **b))
    refs = jax_refs[GRAD_CASE + ("grads",)]
    for name, o, s, j in zip(("xyz", "opacity", "means2d_offset"), ours,
                             single, refs):
        s = s.numpy()
        for ref in (s, j):
            scale = np.abs(ref).max() + 1e-8
            np.testing.assert_allclose(o / scale, ref.reshape(o.shape)
                                       / scale, atol=2e-4, err_msg=name)
    assert np.abs(ours[2]).sum() > 0       # the densification hook is fed


def test_band_config_validates_divisibility():
    with pytest.raises(ValueError, match="tiles_y=5 must divide"):
        band_config(RasterizeConfig(80, 80), 2)
    b = band_config(RasterizeConfig(64, 72), 4)
    assert b.image_height == 16 and b.image_width == 80
