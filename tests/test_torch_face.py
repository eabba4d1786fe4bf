"""The port's face adaptation step against the JAX package's one-step
``make_face_block`` (serial path, exact selection, XLA composite) at 64x64
with 300 live splats in a capacity of 512 and K=64, on the same cloud,
frames and motion-net weights; and a short run of the port alone.

The JAX gradients are read from the first Adam moments, mu / (1 - b1), as
every optimizer state starts at zero. On the CPU the port's "kernel"
backend runs the plain versions of its kernels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.bench_utils import synthetic_frame_batch as j_frames
from instag_tpu.bench_utils import synthetic_state as j_state
from instag_tpu.config import OptimizationConfig as JOptConfig
from instag_tpu.models import gaussians as JG
from instag_tpu.models import motion as JM
from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.train import face as JF
from instag_tpu.train.optim import pmf_optimizer as j_pmf_opt
from instag_tpu.train.optim import umf_optimizer as j_umf_opt
from instag_torch.bench_utils import synthetic_frame_batch
from instag_torch.config import OptimizationConfig
from instag_torch.io.from_jax import (frame_batch, gaussian_state,
                                      load_motion_net, motion_state_dict)
from instag_torch.models import gaussians as G
from instag_torch.models import motion as TM
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.train.face import Flags, make_face_block
from tests.test_torch_motion import flax_tree
from tests.torch_cpu import one_torch_thread  # noqa: F401

SIZE, K, N_LIVE, CAP = 64, 64, 300, 512
FIELDS = G.PARAM_FIELDS
FLAGS = dict(align=1.0, use_regs=1.0, use_sapiens=1.0, use_depth=1.0,
             hair_paint=0.0, use_lpips=0.0)
B1 = 0.9


def _adam_mu(opt_state) -> dict:
    """The first moments of an optax multi-transform state as one flax-style
    tree (each label's masked state holds its own parameters)."""
    tree = {}

    def walk(s):
        if hasattr(s, "mu") and hasattr(s, "nu"):
            for path, leaf in jax.tree_util.tree_flatten_with_path(s.mu)[0]:
                node = tree
                keys = [getattr(k, "key", str(k)) for k in path]
                for key in keys[:-1]:
                    node = node.setdefault(key, {})
                node[keys[-1]] = np.asarray(leaf)
        elif isinstance(s, dict):
            for v in s.values():
                walk(v)
        elif isinstance(s, (tuple, list)):
            for v in s:
                walk(v)
        for name in ("inner_states", "inner_state"):
            if hasattr(s, name):
                walk(getattr(s, name))

    walk(opt_state)
    return tree


def _close(ours, ref, name, atol_frac=5e-4, rtol=2e-3):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert np.isfinite(ours).all(), name
    scale = max(1e-12, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, atol=atol_frac * scale, rtol=rtol,
                               err_msg=name)


def _scene(has_priors):
    # spread so that no tile holds more than K splats: a K cut would make
    # the selection hang on the last bits of the moved depths
    state = j_state(N_LIVE, CAP, seed=0, spread=1.0, scale=0.03)
    batch = j_frames(SIZE, n_frames=2, seed=1)
    if has_priors:
        rng = np.random.default_rng(5)
        normal = rng.normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        depth = rng.uniform(0.5, 2.0, (2, SIZE, SIZE)).astype(np.float32)
        batch = batch.replace(normal=jnp.asarray(normal),
                              depth=jnp.asarray(depth))
    return state, batch


def _jax_step(state, batch, umf_params, pmf_params, has_priors):
    cfg = JConfig(SIZE, SIZE, max_per_tile=K, tile_chunk=8,
                  approx_topk=False, backend="xla")
    umf_net, pmf_net = JM.MotionNetwork(), JM.PersonalizedMotionNetwork("face")
    umf_tx, umf_opt = j_umf_opt(umf_params)
    pmf_tx, pmf_opt = j_pmf_opt(pmf_params)
    block = JF.make_face_block(cfg, JOptConfig(), umf_net, pmf_net, 1.0,
                               has_priors, umf_tx, pmf_tx)
    flags = JF.Flags(**{k: jnp.ones((1,)) * v for k, v in FLAGS.items()},
                     valid=jnp.ones((1,)))
    out = block(state, JG.adam_init(state.params), umf_params, umf_opt,
                pmf_params, pmf_opt, batch, jnp.zeros((1, 1), jnp.int32),
                jnp.ones((1,), jnp.int32), flags, jnp.zeros((1,), jnp.int32),
                {})
    return jax.device_get(out)


@pytest.mark.parametrize("has_priors", [False, True])
def test_face_step_matches_jax(has_priors):
    state, batch = _scene(has_priors)
    tnets = [TM.MotionNetwork(), TM.PersonalizedMotionNetwork("face")]
    params = [flax_tree(n, np.random.default_rng(30 + i))
              for i, n in enumerate(tnets)]
    # the JAX block donates its carry: take the port's copy first
    t_state = gaussian_state(
        {f: np.asarray(getattr(state.params, f)) for f in FIELDS},
        np.asarray(state.alive), int(state.active_sh_degree),
        state.max_sh_degree, device="cpu",
        stats={k: np.asarray(getattr(state, k))
               for k in ("max_radii2d", "xyz_grad_accum", "denom")},
        spatial_lr_scale=state.spatial_lr_scale)
    (j_state1, j_gopt, _, j_umf_opt_state, _, j_pmf_opt_state,
     j_losses) = _jax_step(state, batch, params[0], params[1], has_priors)

    t_batch = frame_batch({k: (None if v is None else np.asarray(v))
                           for k, v in vars(batch).items()}, device="cpu")
    umf, pmf = (load_motion_net(n, p, device="cpu")
                for n, p in zip(tnets, params))
    block = make_face_block(RasterizeConfig(SIZE, SIZE, max_per_tile=K),
                            OptimizationConfig(), umf, pmf, 1.0, has_priors,
                            device="cpu")
    t_state1, t_gopt, losses = block(t_state, G.adam_init(t_state.params),
                                     t_batch, [0], [1], Flags(**FLAGS))

    np.testing.assert_allclose(float(losses[0]), float(j_losses[0]),
                               rtol=1e-5)
    assert int((t_state1.denom > 0).sum()) > 100
    for f in FIELDS:
        _close(getattr(t_gopt.mu, f) / (1 - B1),
               np.asarray(getattr(j_gopt.mu, f)) / (1 - B1), f)
    for name in ("xyz_grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(t_state1, name).numpy(),
                                   np.asarray(getattr(j_state1, name)),
                                   rtol=2e-4, atol=1e-7, err_msg=name)

    # the nets: PMF's audio_att adds its L2 decay 1e-4 p to the gradient
    # before Adam, so its first moment holds g + 1e-4 p (g is 0 there: the
    # PMF's audio branch does not reach the loss without personalization)
    for net, p0, opt_state in ((umf, params[0], j_umf_opt_state),
                               (pmf, params[1], j_pmf_opt_state)):
        ref = motion_state_dict(_adam_mu(opt_state))
        start = motion_state_dict(p0)
        grads = {n: p.grad for n, p in net.named_parameters()}
        assert set(ref) == set(grads)
        for n, g in grads.items():
            if net is pmf and "audio_att_net" in n:
                g = g + 1e-4 * start[n]
            _close(g.numpy(), ref[n].numpy() / (1 - B1), n)


def test_face_block_loss_falls_on_cpu():
    """A few port steps on the CPU: finite losses that fall, on one frame."""
    from instag_torch.bench_utils import (synthetic_motion_params,
                                          synthetic_state)
    nets = synthetic_motion_params(seed=2, device="cpu")
    state = synthetic_state(N_LIVE, CAP, seed=3, spread=0.4, scale=0.03,
                            device="cpu")
    batch = synthetic_frame_batch(SIZE, n_frames=1, seed=4, device="cpu")
    block = make_face_block(RasterizeConfig(SIZE, SIZE, max_per_tile=K),
                            OptimizationConfig(), nets["face_umf"],
                            nets["face_pmf"], 1.0, False, device="cpu")
    state, gopt, losses = block(state, G.adam_init(state.params), batch,
                                [0] * 6, range(1, 7), Flags(**FLAGS))
    losses = losses.numpy()
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert gopt.step == 6 and float(state.denom.max()) == 6.0
