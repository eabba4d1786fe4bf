"""The whole synthesis frame — face branch, mouth branch and their fusion,
personalized and aligned — against the JAX package's frame (the
``__graft_entry__.entry`` recipe with exact selection) at 64x64, on the same
clouds and motion-net weights (carried across by io/from_jax.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.bench_utils import synthetic_camera as j_camera
from instag_tpu.bench_utils import synthetic_state as j_state
from instag_tpu.models import motion as JM
from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.render import (composite_fuse as j_fuse,
                               dilate_alpha as j_dilate,
                               render_motion as j_render_motion,
                               render_motion_mouth as j_render_mouth)
from instag_torch.io.from_jax import gaussian_state, load_motion_net
from instag_torch.models import motion as TM
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.render import Camera, dilate_alpha
from instag_torch.synthesize import (SynthesisModel, make_synthesis_fn,
                                     synthesize_frame)
from tests.test_torch_motion import flax_tree
from tests.torch_cpu import one_torch_thread  # noqa: F401

SIZE = 64
FIELDS = ("xyz", "features_dc", "features_rest", "identity", "scaling",
          "rotation", "opacity")


@pytest.fixture(scope="module")
def frame():
    """Inputs, the JAX float frame, and the port's model on the CPU."""
    rng = np.random.default_rng(0)
    face = j_state(300, 512, seed=0, spread=0.12, scale=0.02)
    mouth = j_state(120, 256, seed=1, spread=0.05, scale=0.015)
    cam = j_camera(SIZE, fov=0.2)
    aud = rng.normal(size=(8, 29, 16)).astype(np.float32)
    exp = np.abs(rng.normal(0.3, 0.2, 6)).astype(np.float32)
    torso = rng.uniform(0, 1, (3, SIZE, SIZE)).astype(np.float32)

    tnets = [TM.MotionNetwork(), TM.MouthMotionNetwork(),
             TM.PersonalizedMotionNetwork("face"),
             TM.PersonalizedMotionNetwork("mouth")]
    params = [flax_tree(n, np.random.default_rng(20 + i))
              for i, n in enumerate(tnets)]
    face_net = JM.MotionNetwork(onehot=False)
    mouth_net = JM.MouthMotionNetwork(onehot=False)
    face_pmf = JM.PersonalizedMotionNetwork("face", onehot=False)
    mouth_pmf = JM.PersonalizedMotionNetwork("mouth", onehot=False)
    cfg = JConfig(SIZE, SIZE, max_per_tile=256, approx_topk=False,
                  backend="xla")
    green = jnp.array([0.0, 1.0, 0.0], jnp.float32)

    def fn(aud, exp, torso):
        fr = j_render_motion(
            cfg, cam, face,
            umf=lambda x, a, e: face_net.apply(params[0], x, a, e),
            aud=aud, exp=exp, bg=green,
            pmf=lambda x, a, e: face_pmf.apply(params[2], x, a, e),
            personalized=True, align=True)
        mr = j_render_mouth(
            cfg, cam, mouth,
            mouth_umf=lambda x, a, m: mouth_net.apply(params[1], x, a, m),
            face_state=face, face_umf=None, aud=aud, bg=green,
            pmf=lambda x, a: mouth_pmf.apply(params[3], x, a),
            personalized=True, align=True, face_motion_cache=fr.motion)
        return j_fuse(fr.out.image, fr.out.alpha, mr.out.image,
                      mr.out.alpha, green, torso), fr.out.alpha, mr.out.alpha

    ref, face_alpha, mouth_alpha = jax.jit(fn)(aud, exp, torso)
    # both branches cover a real part of the frame
    assert float(face_alpha.mean()) > 0.1 and float(mouth_alpha.mean()) > 0.02

    def state(s):
        return gaussian_state({f: np.asarray(getattr(s.params, f))
                               for f in FIELDS}, np.asarray(s.alive),
                              int(s.active_sh_degree), s.max_sh_degree,
                              device="cpu")

    nets = [load_motion_net(n, p, device="cpu") for n, p in zip(tnets, params)]
    model = SynthesisModel(state(face), state(mouth), *nets)
    tcam = Camera(*(torch.from_numpy(np.array(v)) for v in (
        cam.view_transform, cam.full_proj_transform, cam.camera_center,
        cam.tanfovx, cam.tanfovy)))
    inputs = tuple(map(torch.from_numpy, (aud, exp, torso)))
    return np.asarray(ref), model, tcam, inputs


@pytest.mark.parametrize("backend", ["kernel", "plain"])
def test_frame_matches_jax(frame, backend):
    ref, model, cam, (aud, exp, torso) = frame
    cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256, backend=backend)
    with torch.no_grad():
        img = synthesize_frame(cfg, model, cam, aud, exp, torso,
                               personalized=True)
    assert img.shape == (3, SIZE, SIZE) and torch.isfinite(img).all()
    np.testing.assert_allclose(img.numpy(), ref, atol=1e-4)


def test_uint8_frame_matches_jax(frame):
    ref, model, cam, (aud, exp, torso) = frame
    synth = make_synthesis_fn(RasterizeConfig(SIZE, SIZE, max_per_tile=256),
                              personalized=True, device="cpu")
    u8 = synth(model, cam, aud, exp, torso)
    assert u8.dtype == torch.uint8 and u8.shape == (SIZE, SIZE, 3)
    ref_u8 = (np.clip(ref, 0.0, 1.0) * 255.0).astype(np.uint8).transpose(1, 2, 0)
    diff = np.abs(u8.numpy().astype(np.int32) - ref_u8.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def test_dilate_alpha_matches_jax():
    alpha = (np.random.default_rng(4).uniform(size=(1, 40, 40)) > 0.97)
    alpha = alpha.astype(np.float32)
    np.testing.assert_array_equal(
        dilate_alpha(torch.from_numpy(alpha), 13).numpy(),
        np.asarray(j_dilate(jnp.asarray(alpha), 13)))
