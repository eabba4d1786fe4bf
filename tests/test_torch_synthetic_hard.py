"""The port's hard synthetic identity writer against the JAX package's: on
the CPU every file of the scene is byte-identical, the returned motion
models are equal, and the port's reader reads the scene."""

import os

import numpy as np
import pytest

from instag_tpu.data.synthetic_hard import generate_hard_scene as j_generate
from instag_torch.data.dataset import load_frames
from instag_torch.data.synthetic_hard import generate_hard_scene
from tests.torch_cpu import one_torch_thread  # noqa: F401

ARGS = dict(n_frames=24, size=128, seed=3, n_val=4)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("hard")
    ref, ours = str(root / "jax"), str(root / "port")
    return (ref, j_generate(ref, **ARGS),
            ours, generate_hard_scene(ours, **ARGS, device="cpu"))


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_files_are_byte_identical(scenes):
    ref, _, ours, _ = scenes
    names = _files(ref)
    assert names == _files(ours)
    assert len(names) == 5 * 28 + 6      # per frame: jpg, png x2, npy, lms
    for name in names:
        with open(os.path.join(ref, name), "rb") as f, \
                open(os.path.join(ours, name), "rb") as g:
            assert f.read() == g.read(), name


def test_motion_models_are_equal(scenes):
    _, j_motion, _, motion = scenes
    for attr in ("a", "S0", "S1", "dS", "blink", "brow"):
        np.testing.assert_array_equal(getattr(motion, attr),
                                      getattr(j_motion, attr), err_msg=attr)
    assert motion.t0 == j_motion.t0 and motion.art_dims == 8
    for t in (0, 5, 27):
        np.testing.assert_array_equal(motion.params(t), j_motion.params(t))


def test_reader_reads_the_scene(scenes):
    ours = scenes[2]
    train = load_frames(ours, "train", device="cpu")
    val = load_frames(ours, "val", device="cpu")
    assert len(train) == 24 and len(val) == 4
    r = train[5]
    assert (r.height, r.width) == (128, 128)
    assert tuple(r.image.shape) == (128, 128, 3)
    assert r.face_mask.any() and r.mouth_mask.any() and r.hair_mask.any()
    # AU45 is twice the blink signal: the reader's blink is AU45 / 2
    blinks = np.array([x.blink for x in train + val])
    np.testing.assert_allclose(blinks, np.clip(scenes[3].blink, 0, 1),
                               atol=1e-6)
