"""The port's face adaptation loop against the JAX package's ``train_face``.

The whole loop runs on a generated scene (8 frames at 80x80, 200 initial
splats in a capacity of 1024, K=256 so that no tile is cut) for 15 steps
with a densification interval of 5 from step 2: three blocks, the
green/depth prune at each block end, a log point at each, the regularisers
switched on at ``warm_step`` 7 inside the second block and the curriculum's
blink window at step 10. (Densification itself starts 1000 steps before the
end of a run, so a run this short never densifies; the densification
functions are held against JAX in tests/test_torch_densify.py.) Both loops
get the same frames, the same starting nets (the JAX loop's own
initialisation, carried by ``from_jax``) and the same curriculum seed; the
JAX side runs with exact selection and without LPIPS, as the port does.

Tolerances: per-step losses within rtol 1e-3 (Adam with eps 1e-15 moves a
parameter by its learning rate on the sign of a gradient that is rounding
noise, such as the rotations of isotropic splats, so the two clouds drift
apart in their last bits step by step); the final alive mask equal.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import instag_tpu.train.common as j_common
from instag_tpu.config import ModelConfig as JModelConfig
from instag_tpu.config import OptimizationConfig as JOptConfig
from instag_tpu.data.synthetic import generate_scene
from instag_tpu.bench_utils import synthetic_state as j_state
from instag_tpu.models import motion as JM
from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.ops.rasterize import selection_stats as j_selection_stats
from instag_tpu.train import face as JF
from instag_tpu.train.optim import umf_schedule as j_umf_schedule
from instag_torch.bench_utils import synthetic_camera
from instag_torch.config import ModelConfig, OptimizationConfig
from instag_torch.io.from_jax import frame_batch, frame_meta, load_motion_net
from instag_torch.models import motion as TM
from instag_torch.ops.rasterize import RasterizeConfig, selection_stats
from instag_torch.train import face as TF
from instag_torch.train.common import FrameMeta
from instag_torch.train.optim import umf_schedule
from tests.torch_cpu import one_torch_thread  # noqa: F401

LOSS_RTOL = 1e-3


def test_face_patch_sizes_match_jax():
    for h, w in ((64, 64), (80, 100), (512, 512), (40, 64)):
        assert TF.face_patch_sizes(h, w) == JF.face_patch_sizes(h, w)


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_frame_curriculum_matches_jax_draw_for_draw(seed):
    """300 iterations across warm_step 150 (the mouth window, then the
    blink window), with windows narrow enough that some selections fall
    back to the nearest frame."""
    rng = np.random.default_rng(40 + seed)
    mouth = [float(x) for x in rng.integers(1, 12, 16)]
    meta = {"mouth": mouth, "blink": list(rng.uniform(0, 1, 16)),
            "mouth_lb": min(mouth), "mouth_ub": max(mouth)}
    picks = _curriculum_picks(meta, 300, 150, seed=seed)
    assert all(a == b for a, b in picks)
    assert len({a for a, _ in picks}) == 16


def _t_meta(meta: dict) -> FrameMeta:
    n = len(meta["mouth"])
    return FrameMeta(blink=meta["blink"], mouth=meta["mouth"],
                     mouth_lb=meta["mouth_lb"], mouth_ub=meta["mouth_ub"],
                     au25=np.zeros(n), au25_pcts=(0, 0, 0, 0),
                     mouth_px=np.zeros(n, int))


def _curriculum_picks(meta: dict, iterations: int, warm_step: int,
                      its=None, seed=0):
    """(JAX pick, port pick) at each step, from one seed; the JAX side reads
    the dict of Python floats, the port a FrameMeta of the same values.
    Both generators and stacks must end in the same state."""
    r_j, r_t = np.random.default_rng(seed), np.random.default_rng(seed)
    s_j, s_t = [], []
    t_meta = _t_meta(meta)
    its = range(1, iterations + 1) if its is None else its
    picks = [(JF.sample_frame_curriculum(r_j, meta, s_j, it, warm_step,
                                         iterations),
              TF.sample_frame_curriculum(r_t, t_meta, s_t, it, warm_step,
                                         iterations))
             for it in its]
    assert s_j == s_t and r_j.integers(1 << 30) == r_t.integers(1 << 30)
    return picks


def _jax_draws(meta: dict, iterations: int, warm_step: int, its):
    """JAX's picks at ``its`` and its generator's next draw."""
    rng = np.random.default_rng(0)
    stack = []
    picks = [JF.sample_frame_curriculum(rng, meta, stack, it, warm_step,
                                        iterations) for it in its]
    return picks, int(rng.integers(1 << 30))


def _edge_case(window_edges):
    """The first step whose float64 window edge, put in a frame's value,
    rounds out of the window in float32: (step, edge value)."""
    for it in range(10, 3000, 10):
        lo, hi = window_edges(it)
        for v, outside in ((hi, lambda x: x > hi), (lo, lambda x: x < lo)):
            if outside(float(np.float32(v))):
                return it, v
    raise AssertionError("no edge rounds out of its window")


@pytest.mark.parametrize("field", ["blink", "mouth"])
def test_curriculum_window_edges_read_in_float64(field):
    """A frame whose value sits exactly on a window edge in float64, and
    whose float32 rounding falls outside the window. Every other frame lies
    far outside it, so the window test alone decides the pick: with the
    float64 FrameMeta the port picks as JAX does from the records' floats,
    draw for draw, while the float32 values make JAX itself draw otherwise
    (the window misses, so it redraws 100 times before its nearest-frame
    fallback: the fault the FrameMeta repairs)."""
    iterations = 3000
    if field == "blink":
        warm_step = 1           # the blink window from the first step

        def edges(it):
            lo = (1.0 / iterations) * it
            return lo - 0.4 * 1.5, lo + 0.4
    else:
        warm_step = iterations + 1    # the mouth window throughout
        lb0, ub0 = 0.1, 0.7

        def edges(it):
            lb = lb0 + (ub0 - lb0) * 0.2
            window = (ub0 - lb) * 0.5
            lo = lb + (1.0 / iterations) * it * (ub0 - lb)
            return lo - window, lo + window
    it, v = _edge_case(edges)
    far = 50.0                   # outside every window of the run
    vals = [far] * 8
    vals[3] = v
    meta = {"mouth": [far] * 8, "blink": [far] * 8, "mouth_lb": 0.1,
            "mouth_ub": 0.7}
    meta[field] = vals
    its = [it, it + 1, it + 2]
    picks = _curriculum_picks(meta, iterations, warm_step, its=its)
    assert all(a == b for a, b in picks) and picks[0] == (3, 3)
    rounded = dict(meta, **{field: [float(np.float32(x)) for x in vals]})
    assert _jax_draws(rounded, iterations, warm_step, its) != _jax_draws(
        meta, iterations, warm_step, its)


def test_selection_stats_match_jax():
    state = j_state(300, 512, seed=2, spread=0.4, scale=0.03)
    cam = synthetic_camera(64, device="cpu")
    mats = [c.numpy() for c in (cam.view_transform, cam.full_proj_transform,
                                cam.camera_center, cam.tanfovx,
                                cam.tanfovy)]
    args = [np.array(a) for a in (state.params.xyz, state.get_scaling(),
                                  state.get_rotation())]
    for k in (16, 256):
        ref = j_selection_stats(
            JConfig(64, 64, max_per_tile=k, approx_topk=False),
            *map(jnp.asarray, args + mats), active=state.alive)
        ours = selection_stats(RasterizeConfig(64, 64, max_per_tile=k),
                               *map(torch.from_numpy, args + mats),
                               active=torch.from_numpy(np.array(
                                   state.alive)))
        for name in ("mean_hits", "max_hits", "saturated_frac"):
            assert float(ours[name]) == pytest.approx(float(ref[name]),
                                                      rel=1e-6), name
        assert (float(ours["saturated_frac"]) > 0) == (k == 16)


@pytest.mark.parametrize("long", [False, True])
def test_umf_schedule_matches_jax(long):
    ours = umf_schedule(1200, 300, long)
    ref = j_umf_schedule(1200, 300, long)
    for step in (0, 1, 299, 300, 301, 600, 1199, 1200):
        assert ours(step) == pytest.approx(float(ref(step)), rel=1e-6)
    # the step builds its UMF schedule from the run's own values
    step = TF.make_face_step(RasterizeConfig(32, 32), OptimizationConfig(),
                             TM.MotionNetwork(),
                             TM.PersonalizedMotionNetwork("face"), 1.0,
                             False, device="cpu", total_iters=1200,
                             warm_step=300, long=long)
    assert step.umf_sched.lr_lambdas[0](900) == pytest.approx(
        (0.1 if long else 0.5) ** 0.75)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("face_loop_scene"))
    generate_scene(path, n_frames=8, size=80)
    return path


def test_train_face_matches_jax(scene_dir, monkeypatch, capsys):
    iterations, warm_step, seed = 15, 7, 0
    oc = dict(iterations=iterations, densify_from_iter=2,
              densification_interval=5)
    records = j_common.load_training_frames(
        JModelConfig(source_path=scene_dir))
    monkeypatch.setattr(j_common, "load_training_frames",
                        lambda model_cfg: records)
    j_batch = j_common.build_frame_batch(records)

    # the JAX loop's own starting nets
    k1, k2, _ = jax.random.split(jax.random.key(seed), 3)
    x0 = jnp.zeros((8, 3))
    umf_params, pmf_params = (
        jax.jit(net.init)(k, x0, j_batch.auds[0], j_batch.au_exp[0])
        for net, k in ((JM.MotionNetwork(), k1),
                       (JM.PersonalizedMotionNetwork("face"), k2)))
    umf = load_motion_net(TM.MotionNetwork(), jax.device_get(umf_params),
                          device="cpu")
    pmf = load_motion_net(TM.PersonalizedMotionNetwork("face"),
                          jax.device_get(pmf_params), device="cpu")
    t_batch = frame_batch({k: None if v is None else np.asarray(v)
                           for k, v in vars(j_batch).items()}, device="cpu")

    ref = JF.train_face(
        JModelConfig(source_path=scene_dir, init_num=200, capacity=1024,
                     max_per_tile=256, approx_topk=False),
        JOptConfig(**oc), log_every=5, warm_step=warm_step, seed=seed,
        lpips_enabled=False)
    j_log = capsys.readouterr().out
    res = TF.train_face(
        ModelConfig(init_num=200, capacity=1024, max_per_tile=256),
        OptimizationConfig(**oc), t_batch, frame_meta(records), umf_net=umf,
        pmf_net=pmf, log_every=5, warm_step=warm_step, seed=seed,
        lpips_enabled=False, device="cpu")
    t_log = capsys.readouterr().out

    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=LOSS_RTOL)
    alive = res["state"].alive.numpy()
    np.testing.assert_array_equal(alive, np.asarray(ref["state"].alive))
    assert 100 < alive.sum() < 200              # the depth prune ran
    assert res["state"].capacity == ref["state"].capacity == 1024
    assert res["extent"] == pytest.approx(ref["extent"], rel=1e-6)
    assert res["max_sh_degree"] == ref["max_sh_degree"] == 1
    assert res["gopt"].step == iterations

    def counts(log):
        return re.findall(r"\[face (\d+)/15\] loss=\S+ pts=(\d+)", log)
    assert counts(t_log) == counts(j_log) and len(counts(t_log)) == 3
