"""The port's mesh renderer (``instag_torch.data_utils.mesh_render``)
against the JAX package's on the CPU, at 64x64 on the synthetic head of
tests/test_tracker_photometric.py: coverage equal but for at most
``EDGE_PIXELS`` pixels, RGB within 1e-5 where both cover the pixel, the
gradients in the vertices and the colours within 1e-4 of their scale
under one shared cotangent, and, on a fan of tied triangles that puts
more than K in one tile, the same candidate triangles as ``jax.lax.top_k``
keeps (the lower index among equal keys)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instag_tpu.data_utils import face_model as JF
from instag_tpu.data_utils import mesh_render as JM
from instag_tpu.data_utils.photometric import transform_points
from instag_torch.data_utils import mesh_render as TM
from tests.torch_cpu import one_torch_thread  # noqa: F401

H = W = 64
FOCAL, C = 150.0, 32.0
EDGE_PIXELS = 4          # coverage may differ on triangle edges (measured 0)
RGB_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture(scope="module")
def scene():
    """Three lit frames of the synthetic head: camera-space vertices and
    colours [3, V, 3]."""
    m = JF.synthetic_model()
    rng = np.random.default_rng(0)
    idp = jnp.asarray(0.6 * rng.normal(size=(m.n_id,)), jnp.float32)
    texp = jnp.asarray(0.5 * rng.normal(size=(m.n_tex,)), jnp.float32)
    light = np.zeros(27, np.float32)
    light[:3], light[3:6] = 1.5, 0.35

    @jax.jit        # one compile for the three frames, not one an operation
    def frame(exp, euler):
        vc = transform_points(JF.geometry(m, idp, exp), euler,
                              jnp.asarray([0.01, -0.01, 0.85], jnp.float32))
        shade = jnp.maximum(JF.sh_shading(JF.vertex_normals(vc, m.tris),
                                          jnp.asarray(light)), 0.0)
        return vc, jnp.clip(JF.texture(m, texp) * shade, 0, 1)
    vcs, cols = [], []
    for i in range(3):
        exp = jnp.asarray(0.5 * rng.normal(size=(m.n_exp,)), jnp.float32)
        vc, col = frame(exp, jnp.asarray(0.1 * rng.normal(size=3),
                                         jnp.float32))
        vcs.append(np.asarray(vc))
        cols.append(np.asarray(col))
    return m.tris, np.stack(vcs), np.stack(cols)


def test_render_matches_jax(scene):
    tris, vcs, cols = scene
    cfg = JM.MeshRenderConfig(H, W)
    render = jax.jit(jax.vmap(lambda v, c: JM.render_mesh(
        cfg, v, jnp.asarray(tris), c, FOCAL, C, C)))
    want = np.asarray(render(jnp.asarray(vcs), jnp.asarray(cols)))
    got = TM.render_mesh(TM.MeshRenderConfig(H, W), torch.from_numpy(vcs),
                         tris, torch.from_numpy(cols), FOCAL, C, C).numpy()
    assert got.shape == want.shape == (3, H, W, 4)
    assert want[..., 3].mean() > 0.05
    assert np.count_nonzero(got[..., 3] != want[..., 3]) <= EDGE_PIXELS
    both = (got[..., 3] > 0) & (want[..., 3] > 0)
    assert np.abs(got[..., :3] - want[..., :3])[both].max() <= RGB_TOL
    single = TM.render_mesh(TM.MeshRenderConfig(H, W),
                            torch.from_numpy(vcs[1]), tris,
                            torch.from_numpy(cols[1]), FOCAL, C, C)
    assert torch.equal(single, torch.from_numpy(got[1]))


def test_gradients_match_jax(scene):
    tris, vcs, cols = scene
    g = np.random.default_rng(1).normal(size=(H, W, 4)).astype(np.float32)
    cfg = JM.MeshRenderConfig(H, W)

    @jax.jit
    def grads(v, c, g):
        _, vjp = jax.vjp(lambda v, c: JM.render_mesh(
            cfg, v, jnp.asarray(tris), c, FOCAL, C, C), v, c)
        return vjp(g)
    want_v, want_c = (np.asarray(a) for a in grads(
        jnp.asarray(vcs[0]), jnp.asarray(cols[0]), jnp.asarray(g)))
    v = torch.from_numpy(vcs[0]).requires_grad_(True)
    c = torch.from_numpy(cols[0]).requires_grad_(True)
    out = TM.render_mesh(TM.MeshRenderConfig(H, W), v, tris, c, FOCAL, C, C)
    (out * torch.from_numpy(g)).sum().backward()
    for got, want in ((v.grad.numpy(), want_v), (c.grad.numpy(), want_c)):
        assert np.abs(want).max() > 0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD_TOL * np.abs(want).max())


def _fan(n=100):
    """A fan of ``n`` triangles round a centre vertex nearer the camera
    than the ring (every triangle's key the same), at the frame's centre,
    and behind it a strip of farther triangles with keys of their own."""
    a = np.linspace(0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([0.05 * np.cos(a), 0.05 * np.sin(a), np.full(n, 1.2)],
                    -1)
    strip = np.stack([np.linspace(-0.3, 0.3, 40), np.tile([0.02, -0.02], 20),
                      np.linspace(1.5, 1.9, 40)], -1)
    verts = np.concatenate([[[0.0, 0.0, 1.0]], ring, strip]).astype(
        np.float32)
    fan = [[0, 1 + i, 1 + (i + 1) % n] for i in range(n)]
    rows = [[1 + n + i, 2 + n + i, 3 + n + i] for i in range(38)]
    tris = np.asarray(rows[:19] + fan + rows[19:], np.int32)
    return verts, tris


def test_tied_keys_at_the_k_cut_keep_jaxs_triangles():
    verts, tris = _fan()
    cfg = JM.MeshRenderConfig(H, W)
    px = FOCAL * verts[:, 0] / verts[:, 2] + C
    py = FOCAL * verts[:, 1] / verts[:, 2] + C
    # the JAX renderer's candidate selection, as its select() computes it
    corner = [np.stack([a[tris[:, k]] for k in range(3)])
              for a in (px, py, verts[:, 2])]
    xmin, xmax = corner[0].min(0), corner[0].max(0)
    ymin, ymax = corner[1].min(0), corner[1].max(0)
    neg_depth = -corner[2].min(0)
    tids = np.arange(cfg.tiles_y * cfg.tiles_x)
    tx, ty = (tids % cfg.tiles_x) * 16.0, (tids // cfg.tiles_x) * 16.0
    hit = ((xmax[None] >= tx[:, None]) & (xmin[None] <= tx[:, None] + 16)
           & (ymax[None] >= ty[:, None]) & (ymin[None] <= ty[:, None] + 16))
    keys = jnp.where(jnp.asarray(hit), jnp.asarray(neg_depth)[None],
                     -jnp.inf)
    vals, want = (np.asarray(a) for a in jax.lax.top_k(keys, 64))
    # more than K triangles in a tile, tied with the last one kept
    assert (hit & (neg_depth == vals[:, -1:])).sum(1).max() > 64
    t = torch.from_numpy
    ids, valid = TM.tile_candidates(
        TM.MeshRenderConfig(H, W), t(px)[None], t(py)[None],
        t(verts[:, 2])[None], t(tris).long(), torch.from_numpy(tids))
    assert np.array_equal(valid[0].numpy(), vals > -np.inf)
    assert np.array_equal(ids[0].numpy()[valid[0].numpy()],
                          want[vals > -np.inf])
    # and the images agree
    colors = np.random.default_rng(2).uniform(size=verts.shape).astype(
        np.float32)
    img_j = np.asarray(JM.render_mesh(cfg, jnp.asarray(verts),
                                      jnp.asarray(tris), jnp.asarray(colors),
                                      FOCAL, C, C))
    img_t = TM.render_mesh(TM.MeshRenderConfig(H, W), t(verts), tris,
                           t(colors), FOCAL, C, C).numpy()
    assert np.array_equal(img_t[..., 3], img_j[..., 3])
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=RGB_TOL)
