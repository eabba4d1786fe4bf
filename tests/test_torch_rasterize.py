"""The port's rasterizer against the JAX package's exact-selection XLA path
on the same scenes (64x64, 150 splats), values and gradients."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.ops import rasterize as J
from instag_torch.ops import rasterize as R
from tests.test_rasterize import make_camera, make_scene
from tests.torch_cpu import one_torch_thread  # noqa: F401

H = W = 64
K = 64


def _jax_cfg():
    return J.RasterizeConfig(H, W, max_per_tile=K, tile_chunk=8,
                             approx_topk=False, backend="xla")


def _port_cfg(backend):
    return R.RasterizeConfig(H, W, max_per_tile=K, backend=backend)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def once():
    """``once(key, fn)``: the JAX reference ``fn()`` of ``key``, computed
    once a module, so that a test's kernel and plain cases share one
    trace of it."""
    refs = {}

    def get(key, fn):
        if key not in refs:
            refs[key] = jax.device_get(fn())
        return refs[key]
    return get


def _close(ours, ref, names=("image", "depth", "normal", "alpha", "extra")):
    for name in names:
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=2e-5, err_msg=name)
    np.testing.assert_array_equal(ours.radii.numpy(), np.asarray(ref.radii))


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("sh_deg", [0, 2])
def test_rasterize_matches_jax(sh_deg, backend, once):
    view, full, campos, tanfov = make_camera(H, W)
    scene = make_scene(n=150, sh_deg=sh_deg, seed=5)
    means, opac, scales, rots, shs = scene
    bg = jnp.array([0.15, 0.25, 0.35], jnp.float32)
    ref = once(("rasterize", sh_deg), lambda: jax.jit(
        lambda *a: J.rasterize(_jax_cfg(), *a, shs=shs, sh_degree=sh_deg))(
            means, opac, scales, rots, view, full, campos, tanfov, tanfov,
            bg))
    tan = torch.tensor(np.float32(tanfov))
    out = R.rasterize(_port_cfg(backend), *map(_t, (means, opac, scales,
                                                     rots, view, full,
                                                     campos)),
                      tan, tan, _t(bg), shs=_t(shs), sh_degree=sh_deg)
    assert out.radii.dtype == torch.int32
    assert int((out.radii > 0).sum()) > 50
    _close(out, ref)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("light", [False, True])
def test_composite_prepared_with_aux_matches_jax(light, backend, once):
    view, full, campos, tanfov = make_camera(H, W)
    means, opac, scales, rots, shs = make_scene(n=150, sh_deg=1, seed=7)
    bg = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    aux = jnp.asarray(np.random.default_rng(3).uniform(
        size=(150, 4)).astype(np.float32))

    def jax_fn(means, scales, rots):
        prep = J.prepare(_jax_cfg(), means, scales, rots, view, full, campos,
                         tanfov, tanfov)
        colors = J.sh_colors(means, campos, shs, 1)
        return J.composite_prepared(_jax_cfg(), prep, opac, colors, bg,
                                    light=light, aux_colors=aux)

    ref, ref_aux = once(("aux", light),
                        lambda: jax.jit(jax_fn)(means, scales, rots))
    cfg = _port_cfg(backend)
    tan = torch.tensor(np.float32(tanfov))
    prep = R.prepare(cfg, _t(means), _t(scales), _t(rots), _t(view),
                     _t(full), _t(campos), tan, tan)
    colors = R.sh_colors(_t(means), _t(campos), _t(shs), 1)
    out, out_aux = R.composite_prepared(cfg, prep, _t(opac), colors, _t(bg),
                                        light=light, aux_colors=_t(aux))
    _close(out, ref)
    np.testing.assert_allclose(out_aux.numpy(), np.asarray(ref_aux),
                               atol=2e-5)
    if light:
        assert float(out.depth.abs().max()) == 0.0


def test_projection_matches_jax():
    view, full, campos, tanfov = make_camera(H, W)
    means, opac, scales, rots, shs = make_scene(n=150, sh_deg=0, seed=2)
    # push a few splats behind and onto the camera plane
    means = means.at[:4, 2].set(jnp.array([-2.0, -1.99999, -1.9, 5.0]))
    ref = J.project_gaussians(_jax_cfg(), means, scales, rots, view, full,
                              campos, tanfov, tanfov)
    tan = torch.tensor(np.float32(tanfov))
    ours = R.project_gaussians(_port_cfg("kernel"), _t(means), _t(scales),
                               _t(rots), _t(view), _t(full), _t(campos),
                               tan, tan)
    for name in ref._fields:
        a, b = getattr(ours, name).numpy(), np.asarray(getattr(ref, name))
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            vis = np.asarray(ref.visible)
            np.testing.assert_allclose(a[vis], b[vis], rtol=1e-5, atol=1e-5,
                                       err_msg=name)
            assert np.isfinite(a).all(), name


def test_reused_selection_matches_jax():
    """``prepare(selection=...)`` reuses an earlier frame's tile lists; the
    composite must then mask splats the current projection culls."""
    view, full, campos, tanfov = make_camera(H, W)
    means, opac, scales, rots, shs = make_scene(n=150, sh_deg=0, seed=11)
    moved = means.at[:, 0].add(0.02).at[:6, 2].set(-3.0)   # 6 now culled
    bg = jnp.array([0.1, 0.2, 0.3], jnp.float32)
    jcfg = _jax_cfg()
    old = J.prepare(jcfg, means, scales, rots, view, full, campos, tanfov,
                    tanfov)
    jprep = J.prepare(jcfg, moved, scales, rots, view, full, campos, tanfov,
                      tanfov, selection=(old.ids, old.valid))
    ref = J.composite_prepared(jcfg, jprep, opac,
                               J.sh_colors(moved, campos, shs, 0), bg,
                               mask_invisible=True)
    tan = torch.tensor(np.float32(tanfov))
    for backend in ("kernel", "plain"):
        cfg = _port_cfg(backend)
        tprep = R.prepare(cfg, _t(moved), _t(scales), _t(rots), _t(view),
                          _t(full), _t(campos), tan, tan,
                          selection=(_t(old.ids), _t(old.valid)))
        out = R.composite_prepared(
            cfg, tprep, _t(opac), R.sh_colors(_t(moved), _t(campos), _t(shs), 0),
            _t(bg), mask_invisible=True)
        _close(out, ref)


@pytest.mark.parametrize("backend", ["kernel", "plain"])
@pytest.mark.parametrize("with_aux", [False, True])
def test_gradients_match_jax(with_aux, backend, once):
    """Gradients of every differentiable input, on the scene and loss of
    tests/test_pallas_composite.py::test_gradients_match_xla. With aux
    channels in the loss, the geometry must see none of their gradient:
    they are composited with stop-gradient weights."""
    h = w = 48
    view, full, campos, tanfov = make_camera(h, w)
    means, opac, scales, rots, shs = make_scene(n=40, seed=11)
    bg = jnp.array([0.4, 0.5, 0.6])
    offset = jnp.zeros((40, 2))
    rng = np.random.default_rng(2)
    tgt = rng.uniform(size=(3, h, w)).astype(np.float32)
    aux = rng.uniform(size=(40, 2)).astype(np.float32)
    jcfg = J.RasterizeConfig(h, w, max_per_tile=48, tile_chunk=4,
                             approx_topk=False, backend="xla")
    cfg = R.RasterizeConfig(h, w, max_per_tile=48, backend=backend)

    def loss(ops, out, aux_img, tgt):
        value = (ops.mean((out.image - tgt) ** 2) + 0.3 * ops.mean(out.alpha)
                 + 0.1 * ops.mean(out.depth)
                 + 0.05 * ops.mean(out.normal ** 2))
        if with_aux:
            value = value + ops.mean((aux_img - 0.3) ** 2)
        return value

    def jax_loss(m, o, s, r, sh, off, a):
        prep = J.prepare(jcfg, m, s, r, view, full, campos, tanfov, tanfov,
                         means2d_offset=off)
        res = J.composite_prepared(jcfg, prep, o, J.sh_colors(m, campos, sh, 1),
                                   bg, aux_colors=a if with_aux else None)
        out, aux_img = res if with_aux else (res, None)
        return loss(jnp, out, aux_img, jnp.asarray(tgt))

    args = (means, opac, scales, rots, shs, offset, jnp.asarray(aux))
    ref = once(("grads", with_aux), lambda: jax.jit(
        jax.grad(jax_loss, argnums=range(7)))(*args))

    m, o, sc, r, sh, off, a = (_t(x).requires_grad_(True) for x in args)
    tan = torch.tensor(np.float32(tanfov))
    prep = R.prepare(cfg, m, sc, r, _t(view), _t(full), _t(campos), tan, tan,
                     means2d_offset=off)
    res = R.composite_prepared(cfg, prep, o, R.sh_colors(m, _t(campos), sh, 1),
                               _t(bg), aux_colors=a if with_aux else None)
    out, aux_img = res if with_aux else (res, None)
    loss(torch, out, aux_img, torch.from_numpy(tgt)).backward()
    names = ["means", "opacity", "scales", "rotations", "shs", "means2d",
             "aux"][:7 if with_aux else 6]
    for name, x, want in zip(names, (m, o, sc, r, sh, off, a), ref):
        want = np.asarray(want)
        scale = max(1e-6, float(np.abs(want).max()))
        np.testing.assert_allclose(x.grad.numpy(), want, atol=5e-4 * scale,
                                   rtol=2e-3, err_msg=name)
    assert float(off.grad.abs().sum()) > 0      # densification hook alive
