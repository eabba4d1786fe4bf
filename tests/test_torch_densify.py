"""The port's cloud construction, densification, pruning and capacity resize
against the JAX package's functions on the same numpy inputs.

The split draws its children from two standard-normal samples per slot:
the JAX package draws them from its key inside ``densify_and_prune``; the
port takes them as an argument, so these tests feed it JAX's own draws.
Alive masks must be equal. Parameters copied from a parent are equal; the
computed ones (a child's position through the parent's rotation, a child's
scale through softplus_inverse, the kNN scales) agree within rtol 1e-5 and
atol 1e-6 (float32 rounding of differently ordered sums; kNN within rtol
1e-4, the |a|^2 + |b|^2 - 2 a.b form cancels); Adam moments, statistics
and counters are equal.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.models import gaussians as JG
from instag_tpu.ops.knn import mean_knn_dist2 as j_knn
from instag_tpu.train import face as JF
from instag_torch.io.from_jax import adam_state, gaussian_state
from instag_torch.models import gaussians as G
from instag_torch.ops.knn import mean_knn_dist2
from instag_torch.train import face as TF
from tests.torch_cpu import one_torch_thread  # noqa: F401

FIELDS = G.PARAM_FIELDS
STATS = ("max_radii2d", "xyz_grad_accum", "denom")
EXTENT = 2.0          # percent_dense * extent = 0.01; 0.1 * extent = 0.2
THRESH = 2e-4


def _inv_softplus(y):
    return y + np.log(-np.expm1(-y))


def _scene(n, cap, seed=0, scale=(0.002, 0.03), big=0, green=0):
    """Numpy fields of a cloud: ``n`` live slots of ``cap`` (dead slots
    scattered among them), scales uniform in ``scale`` (the clone / split
    boundary is 0.01), ``big`` live splats of world size 0.3, ``green``
    live splats coloured background green; random rotations, opacities,
    densification statistics (about 70 % of live slots above the gradient
    threshold) and Adam moments."""
    rng = np.random.default_rng(seed)
    f = {
        "xyz": rng.uniform(-0.5, 0.5, (cap, 3)),
        "features_dc": rng.normal(0, 0.5, (cap, 1, 3)),
        "features_rest": rng.normal(0, 0.1, (cap, 3, 3)),
        "identity": rng.normal(0, 1, (cap, 1)),
        "scaling": _inv_softplus(rng.uniform(*scale, (cap, 3))),
        "rotation": rng.normal(0, 1, (cap, 4)),
        "opacity": rng.normal(0, 2, (cap, 1)),
    }
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n]] = True
    live = np.flatnonzero(alive)
    f["scaling"][live[:big]] = _inv_softplus(0.3)
    f["features_dc"][live[big:big + green], 0] = (
        (np.array([0.02, 0.98, 0.02]) - 0.5) / 0.28209479177387814)
    f["features_rest"][live[big:big + green]] = 0.0
    f = {k: v.astype(np.float32) for k, v in f.items()}
    denom = rng.integers(0, 6, cap).astype(np.float32)
    stats = {"denom": denom,
             "xyz_grad_accum": (denom * rng.uniform(0, 6.5e-4, cap)
                                ).astype(np.float32),
             "max_radii2d": rng.uniform(0, 40, cap).astype(np.float32)}
    moments = [{k: rng.normal(0, s, v.shape).astype(np.float32)
                for k, v in f.items()} for s in (1e-3, 1e-6)]
    return f, alive, stats, moments


def _jax_pair(f, alive, stats, moments, dropped=0, step=7):
    state = JG.GaussianState(
        params=JG.GaussianParams(**{k: jnp.asarray(v) for k, v in f.items()}),
        alive=jnp.asarray(alive), active_sh_degree=jnp.int32(1),
        dropped_children=jnp.int32(dropped), spatial_lr_scale=EXTENT,
        max_sh_degree=1, **{k: jnp.asarray(v) for k, v in stats.items()})
    opt = JG.AdamState(
        mu=JG.GaussianParams(**{k: jnp.asarray(v)
                                for k, v in moments[0].items()}),
        nu=JG.GaussianParams(**{k: jnp.asarray(v)
                                for k, v in moments[1].items()}),
        step=jnp.int32(step))
    return state, opt


def _torch_pair(f, alive, stats, moments, dropped=0, step=7, device="cpu"):
    state = gaussian_state(f, alive, 1, 1, device=device, stats=stats,
                           spatial_lr_scale=EXTENT, dropped_children=dropped)
    return state, adam_state(moments[0], moments[1], step, device=device)


def _check(t_state, t_opt, j_state, j_opt, rtol=1e-5, atol=1e-6):
    np.testing.assert_array_equal(t_state.alive.cpu().numpy(),
                                  np.asarray(j_state.alive))
    for k in FIELDS:
        np.testing.assert_allclose(
            getattr(t_state.params, k).cpu().numpy(),
            np.asarray(getattr(j_state.params, k)), rtol=rtol, atol=atol,
            err_msg=k)
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(
                getattr(getattr(t_opt, m), k).cpu().numpy(),
                np.asarray(getattr(getattr(j_opt, m), k)), err_msg=f"{m} {k}")
    for k in STATS:
        np.testing.assert_array_equal(getattr(t_state, k).cpu().numpy(),
                                      np.asarray(getattr(j_state, k)),
                                      err_msg=k)
    assert t_state.dropped_children == int(j_state.dropped_children)
    assert t_opt.step == int(j_opt.step)
    assert t_state.active_sh_degree == int(j_state.active_sh_degree)


def _split_draws(key, cap):
    """The two [C, 3] draws ``densify_and_prune`` takes from ``key``."""
    draws = []
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.normal(sub, (cap, 3))))
    return torch.from_numpy(np.stack(draws))


@pytest.mark.parametrize("n,block", [(1000, 4096), (1000, 256), (37, 16)])
def test_mean_knn_dist2_matches_jax(n, block):
    pts = np.random.default_rng(n).uniform(-0.1, 0.1, (n, 3)).astype(
        np.float32)
    ref = np.asarray(j_knn(jnp.asarray(pts), block=block))
    ours = mean_knn_dist2(torch.from_numpy(pts), block=block).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-9)


def test_create_from_points_matches_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
    cols = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    j = JG.create_from_points(jnp.asarray(pts), jnp.asarray(cols), 512, 2,
                              0.75)
    t = G.create_from_points(torch.from_numpy(pts), torch.from_numpy(cols),
                             512, 2, 0.75)
    np.testing.assert_array_equal(t.alive.numpy(), np.asarray(j.alive))
    for k in FIELDS:
        np.testing.assert_allclose(getattr(t.params, k).numpy(),
                                   np.asarray(getattr(j.params, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert (t.active_sh_degree, t.max_sh_degree, t.spatial_lr_scale) == (
        0, 2, 0.75)
    for k in STATS:
        assert not getattr(t, k).any()
    with pytest.raises(ValueError):
        G.create_from_points(torch.from_numpy(pts), torch.from_numpy(cols),
                             100)


CASES = ["clone", "split", "mixed", "overflow", "screen_size"]


@pytest.mark.parametrize("case", CASES)
def test_densify_and_prune_matches_jax(case):
    n, cap = 200, 512
    scale, big, max_screen = (0.002, 0.03), 0, None
    if case == "clone":
        scale = (0.002, 0.0095)
    elif case == "split":
        scale = (0.0105, 0.03)
    elif case == "overflow":
        n = 470            # ~230 wanted children, 42 free slots
    elif case == "screen_size":
        big, max_screen = 12, 20.0
    f, alive, stats, moments = _scene(n, cap, seed=10 + CASES.index(case),
                                      scale=scale, big=big)
    j_state, j_opt = _jax_pair(f, alive, stats, moments, dropped=3)
    t_state, t_opt = _torch_pair(f, alive, stats, moments, dropped=3)
    key = jax.random.key(11)
    floor = 0.3
    j_state, j_opt = JG.densify_and_prune(j_state, j_opt, key, THRESH, floor,
                                          EXTENT, max_screen, 0.005)
    t_state, t_opt = G.densify_and_prune(t_state, t_opt,
                                         _split_draws(key, cap), THRESH,
                                         floor, EXTENT, max_screen, 0.005)
    _check(t_state, t_opt, j_state, j_opt)

    # the case does what it says
    now = t_state.alive.numpy()
    hot = alive & (stats["denom"] > 0) & (
        stats["xyz_grad_accum"] >= THRESH * stats["denom"])
    born = int((now & ~alive).sum())
    if case == "overflow":
        assert born > 0 and t_state.dropped_children > 3 + 100
    else:
        assert born > 50 and t_state.dropped_children == 3
    if case == "clone":                      # parents live on unless faint
        faint = t_state.get_opacity()[:, 0].numpy() < floor
        assert (now | faint)[hot].all()
    if case == "split":
        assert not now[hot].any()            # split parents die
    if case == "screen_size":
        assert not now[np.flatnonzero(alive)[:big]].any()


def test_reset_opacity_matches_jax():
    f, alive, stats, moments = _scene(200, 512, seed=4)
    j = JG.reset_opacity(*_jax_pair(f, alive, stats, moments))
    t = G.reset_opacity(*_torch_pair(f, alive, stats, moments))
    _check(*t, *j)
    assert float(t[0].get_opacity().max()) <= 0.01 + 1e-7
    assert not t[1].mu.opacity.any() and t[1].mu.xyz.any()


def test_prune_mask_matches_jax():
    f, alive, stats, moments = _scene(200, 512, seed=5)
    mask = np.random.default_rng(5).random(512) < 0.3
    j = JG.prune_mask(*_jax_pair(f, alive, stats, moments), jnp.asarray(mask))
    t = G.prune_mask(*_torch_pair(f, alive, stats, moments),
                     torch.from_numpy(mask))
    _check(*t, *j)


@pytest.mark.parametrize("prune_depth", [True, False])
def test_prune_green_and_depth_matches_jax(prune_depth):
    f, alive, stats, moments = _scene(300, 512, seed=6, green=25)
    campos = np.array([0.2, 0.1, 3.3], np.float32)
    j = JF._prune_green_and_depth(*_jax_pair(f, alive, stats, moments),
                                  jnp.asarray(campos), 10, prune_depth)
    t = TF._prune_green_and_depth(*_torch_pair(f, alive, stats, moments),
                                  torch.from_numpy(campos), prune_depth)
    _check(*t, *j)
    killed = int(alive.sum()) - int(t[0].alive.sum())
    assert killed >= 25 + (50 if prune_depth else 0)


@pytest.mark.parametrize("new_cap,keep_slots", [(256, False), (1024, False),
                                                (1024, True), (512, True)])
def test_pack_resize_matches_jax(new_cap, keep_slots):
    f, alive, stats, moments = _scene(150, 512, seed=7)
    if keep_slots and new_cap < 512:
        alive[new_cap:] = False        # the caller's contract when shrinking
    j = JG.pack_resize(*_jax_pair(f, alive, stats, moments, dropped=2),
                       new_cap, keep_slots=keep_slots)
    t = G.pack_resize(*_torch_pair(f, alive, stats, moments, dropped=2),
                      new_cap, keep_slots=keep_slots)
    _check(*t, *j, rtol=0, atol=0)
    assert t[0].capacity == new_cap and int(t[0].alive.sum()) == alive.sum()

    js = JG.pack_resize_state(_jax_pair(f, alive, stats, moments)[0], new_cap,
                              keep_slots=keep_slots)
    ts = G.pack_resize_state(_torch_pair(f, alive, stats, moments)[0],
                             new_cap, keep_slots=keep_slots)
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    for k in FIELDS:
        np.testing.assert_array_equal(getattr(ts.params, k).numpy(),
                                      np.asarray(getattr(js.params, k)))


def test_capacity_policies_match_jax():
    for init_num in (10, 200, 3000, 10_000, 50_000):
        for cap_max in (4096, 32768, 160_768):
            assert G.adaptive_start_capacity(init_num, cap_max) == \
                JG.adaptive_start_capacity(init_num, cap_max)
    for n_alive in (0, 1, 500, 1024, 3000, 5000, 12_000, 23_000, 40_000):
        for cap in (4096, 8192, 32768, 65536):
            for shrink in (True, False):
                args = (n_alive, cap, 160_768)
                assert G.adaptive_capacity_target(*args, allow_shrink=shrink) \
                    == JG.adaptive_capacity_target(*args, allow_shrink=shrink)
