"""The port's morphable model (``instag_torch.data_utils.face_model``)
against the JAX package's on the CPU: ``synthetic_model``'s arrays equal,
the model math (geometry, texture, landmarks, vertex normals, SH shading)
within 1e-6, and both converters writing the same bytes from the same
files (fake reference ``3DMM/`` files as tests/test_tracker_photometric.py
builds them, and a ``savemat`` BFM release)."""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import savemat

from instag_tpu.data_utils import face_model as JF
from instag_torch.data_utils import face_model as TF
from tests.torch_cpu import one_torch_thread  # noqa: F401

TOL = 1e-6


@pytest.mark.parametrize("kw", [{}, dict(n_theta=10, n_phi=7, n_id=3,
                                         n_exp=4, n_tex=2, seed=5)])
def test_synthetic_model_is_jaxs(kw):
    want, got = JF.synthetic_model(**kw), TF.synthetic_model(**kw)
    for name, a, b in zip(want._fields, want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_model_math_matches_jax():
    m = JF.synthetic_model()
    rng = np.random.default_rng(0)
    idp = rng.normal(size=(3, m.n_id)).astype(np.float32)
    expp = rng.normal(size=(3, m.n_exp)).astype(np.float32)
    texp = rng.normal(size=(m.n_tex,)).astype(np.float32)
    light = rng.normal(size=(3, 27)).astype(np.float32)
    t = torch.from_numpy
    geo = TF.geometry(m, t(idp), t(expp))
    np.testing.assert_allclose(
        geo.numpy(), np.asarray(JF.geometry(m, jnp.asarray(idp),
                                            jnp.asarray(expp))), atol=TOL)
    np.testing.assert_allclose(
        TF.texture(m, t(texp)).numpy(),
        np.asarray(JF.texture(m, jnp.asarray(texp))), atol=TOL)
    np.testing.assert_allclose(
        TF.landmarks3d(TF.to_device(m, "cpu"), t(idp), t(expp)).numpy(),
        np.asarray(JF.landmarks3d(m, jnp.asarray(idp), jnp.asarray(expp))),
        atol=TOL)
    verts = geo.numpy() + rng.normal(0, 0.01, geo.shape).astype(np.float32)
    nrm = TF.vertex_normals(t(verts), m.tris)
    want = jax.vmap(lambda v: JF.vertex_normals(v, m.tris))(
        jnp.asarray(verts))
    np.testing.assert_allclose(nrm.numpy(), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(
        TF.sh_shading(nrm, t(light)[:, None]).numpy(),
        np.asarray(JF.sh_shading(want, jnp.asarray(light)[:, None])),
        atol=4 * TOL)


def _reference_model_dir(d, rng):
    """tests/test_tracker_photometric.py:182's fake reference files."""
    V, K_ID, K_EXP, K_TEX = 50, 6, 5, 4
    info = dict(
        mu_shape=rng.normal(0, 1e4, 3 * V),
        b_shape=rng.normal(0, 1.0, (K_ID + 2, 3 * V)),
        sig_shape=rng.uniform(0.5, 2.0, K_ID + 2),
        mu_exp=rng.normal(0, 1e3, 3 * V),
        b_exp=rng.normal(0, 1.0, (K_EXP + 1, 3 * V)),
        sig_exp=rng.uniform(0.5, 2.0, K_EXP + 1),
        mu_tex=rng.uniform(0, 255, 3 * V),
        b_tex=rng.normal(0, 1.0, (K_TEX, 3 * V)),
        sig_tex=rng.uniform(0.5, 2.0, K_TEX))
    keys = dict(keyinds=rng.integers(0, V, 68),
                rigid_ids=rng.integers(0, V, 20),
                left_contour=rng.integers(0, V, (8, 4)),
                right_contour=rng.integers(0, V, (8, 4)))
    topo = dict(tris=rng.integers(0, V, (70, 3)), vert_tris=np.zeros(1),
                sub_inds=np.sort(rng.choice(V, 40, replace=False)))
    d.mkdir()
    np.save(d / "3DMM_info.npy", info)
    np.save(d / "keys_info.npy", keys)
    np.save(d / "topology_info.npy", topo)
    return (K_ID, K_EXP, K_TEX)


def test_convert_bfm_info_writes_jaxs_bytes(tmp_path):
    k_id, k_exp, k_tex = _reference_model_dir(tmp_path / "3DMM",
                                              np.random.default_rng(3))
    outs = []
    for name, mod in (("jax", JF), ("port", TF)):
        out = str(tmp_path / f"{name}.npz")
        mod.convert_bfm_info(str(tmp_path / "3DMM"), out, n_id=k_id,
                             n_exp=k_exp, n_tex=k_tex)
        with open(out, "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
    # and a model written by save_model reads back equal
    m = TF.load_model(str(tmp_path / "port.npz"))
    TF.save_model(str(tmp_path / "again.npz"), m)
    for a, b in zip(m, TF.load_model(str(tmp_path / "again.npz"))):
        assert np.array_equal(a, b)


def test_convert_bfm_mat_writes_jaxs_bytes(tmp_path):
    rng = np.random.default_rng(4)
    V, K = 30, 199
    src = tmp_path / "src"
    src.mkdir()
    savemat(str(src / "01_MorphableModel.mat"), dict(
        shapeMU=rng.normal(size=(3 * V, 1)),
        shapePC=rng.normal(size=(3 * V, K)),
        shapeEV=rng.uniform(0.5, 2, (K, 1)),
        texMU=rng.uniform(0, 255, (3 * V, 1)),
        texPC=rng.normal(size=(3 * V, K)),
        texEV=rng.uniform(0.5, 2, (K, 1))))
    np.save(src / "topology_info.npy", dict(
        sub_inds=np.sort(rng.choice(V, 20, replace=False))))
    np.save(src / "exp_info.npy", dict(
        mu_exp=rng.normal(size=60), base_exp=rng.normal(size=(5, 60)),
        sig_exp=rng.uniform(0.5, 2, 5)))
    outs = []
    for name, mod in (("jax", JF), ("port", TF)):
        shutil.copytree(src, tmp_path / name)
        with open(mod.convert_bfm_mat(str(tmp_path / name)), "rb") as f:
            outs.append(f.read())
    assert outs[0] == outs[1]
