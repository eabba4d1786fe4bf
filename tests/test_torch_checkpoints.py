"""Bundles, PLYs and the flax parameter trees against the JAX package
(instag_tpu/io/checkpoints.py): the port's MessagePack codec, bundles in
both directions with flax's bytes, the state dicts, the PLY pair, and the
inverse of ``from_jax.motion_state_dict``. One small fuse bundle of seeded
JAX states and networks, written once by the JAX package's
``save_bundle``."""


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import serialization as fser

from instag_tpu.bench_utils import synthetic_state as j_state
from instag_tpu.io import checkpoints as JC
from instag_tpu.models import motion as JM
from instag_torch.bench_utils import init_motion_params
from instag_torch.io import checkpoints as TC
from instag_torch.io import msgpack
from instag_torch.io.from_jax import motion_state_dict, state_from_jax
from instag_torch.models import motion as TM
from tests.test_torch_motion import _inputs, _shapes, flax_tree
from tests.torch_cpu import one_torch_thread  # noqa: F401

NETS = {"face_umf": (TM.MotionNetwork, JM.MotionNetwork, ()),
        "mouth_umf": (TM.MouthMotionNetwork, JM.MouthMotionNetwork, ()),
        "face_pmf": (TM.PersonalizedMotionNetwork,
                     JM.PersonalizedMotionNetwork, ("face",)),
        "mouth_pmf": (TM.PersonalizedMotionNetwork,
                      JM.PersonalizedMotionNetwork, ("mouth",))}


def _jax_states():
    face = j_state(300, 512, seed=0, spread=0.2, scale=0.02)
    mouth = j_state(100, 256, seed=1, spread=0.1, scale=0.01)
    # a state with live statistics, a dead slot and dropped children
    face = face.replace(
        alive=face.alive.at[3].set(False),
        denom=jnp.arange(512, dtype=jnp.float32),
        max_radii2d=jnp.linspace(0.0, 5.0, 512, dtype=jnp.float32),
        dropped_children=jnp.int32(7))
    return face, mouth


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """A fuse bundle as the JAX package writes it, and its path."""
    face, mouth = _jax_states()
    bundle = {f"{k}_params": flax_tree(cls(*args), np.random.default_rng(i))
              for i, (k, (cls, _, args)) in enumerate(NETS.items())}
    bundle.update(face_state=JC.state_to_dict(face),
                  mouth_state=JC.state_to_dict(mouth), iteration=2000)
    path = str(tmp_path_factory.mktemp("bundle") / "chkpnt_fuse_latest.pkl")
    JC.save_bundle(path, bundle)
    return bundle, path


def _assert_tree_equal(a, b, path=""):
    assert type(a) is type(b) or (isinstance(a, np.ndarray)
                                  and isinstance(b, np.ndarray)), (path, a, b)
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def test_msgpack_round_trip_and_flax_bytes():
    rng = np.random.default_rng(0)
    tree = {"b": {"x": np.arange(5, dtype=np.int32),
                  "y": rng.normal(size=(3, 4)).astype(np.float32)},
            "ints": {"a": 3, "n": -5, "n8": -100, "n16": -40000,
                     "n64": -2 ** 40, "u8": 200, "u16": 60000, "u32": 70000,
                     "u64": 2 ** 40},
            "f": 1.5, "t": True, "fa": False, "none": None,
            "s": "hello" * 10, "k" * 40: "x", "bytes": b"\x00\x01",
            "np_f32": np.float32(2.5), "np_i32": np.int32(7),
            "np_bool": np.bool_(True), "zero_d": np.asarray(3.0),
            "bools": np.array([True, False]), "empty": {},
            "big": rng.normal(size=(70, 70)).astype(np.float32),
            "many": {f"k{i}": i * 1000 for i in range(20)}}
    data = msgpack.packb(tree)
    assert data == fser.msgpack_serialize(tree)
    _assert_tree_equal(fser.msgpack_restore(data), msgpack.unpackb(data))
    with pytest.raises(ValueError, match="chunked"):
        msgpack.unpackb(fser.msgpack_serialize(
            {"a": {"__msgpack_chunked_array__": True, "shape": {}}}))


def test_jax_bundle_read_by_the_port(jax_bundle):
    _, path = jax_bundle
    _assert_tree_equal(JC.load_bundle(path), TC.load_bundle(path))


def test_port_bundle_read_by_jax_with_flax_bytes(jax_bundle, tmp_path):
    bundle, path = jax_bundle
    port_path = str(tmp_path / "port.pkl")
    TC.save_bundle(port_path, bundle)
    with open(path, "rb") as f, open(port_path, "rb") as g:
        assert f.read() == g.read()
    _assert_tree_equal(JC.load_bundle(path), JC.load_bundle(port_path))
    # a list stores as a {"0": ...} map, as flax's to_state_dict stores it
    TC.save_bundle(port_path, {"xs": [np.ones(2), 3]})
    JC.save_bundle(path + ".list", {"xs": [np.ones(2), 3]})
    assert open(port_path, "rb").read() == open(path + ".list", "rb").read()
    xs = TC.bundle_list(TC.load_bundle(port_path)["xs"])
    assert xs[1] == 3 and np.array_equal(xs[0], np.ones(2))


def test_state_dicts_match_jax(jax_bundle):
    face, _ = _jax_states()
    ref = JC.state_to_dict(face)
    port = TC.state_to_dict(state_from_jax(face, device="cpu"))
    _assert_tree_equal(ref, port)
    back = TC.state_from_dict(jax_bundle[0]["face_state"], device="cpu")
    assert back.dropped_children == 7 and back.active_sh_degree == 1
    _assert_tree_equal(ref, TC.state_to_dict(back))
    j_back = JC.state_from_dict(port)
    _assert_tree_equal(ref, JC.state_to_dict(j_back))


def test_gaussian_ply_pair_matches_jax(tmp_path):
    face, _ = _jax_states()
    JC.save_gaussian_ply(str(tmp_path / "jax.ply"), face)
    TC.save_gaussian_ply(str(tmp_path / "port.ply"),
                         state_from_jax(face, device="cpu"))
    assert (open(tmp_path / "jax.ply", "rb").read()
            == open(tmp_path / "port.ply", "rb").read())
    ref = JC.load_gaussian_ply(str(tmp_path / "jax.ply"), 400, 1)
    out = TC.load_gaussian_ply(str(tmp_path / "jax.ply"), 400, 1,
                               device="cpu")
    _assert_tree_equal(JC.state_to_dict(ref), TC.state_to_dict(out))
    assert int(out.num_alive()) == 299


@pytest.mark.parametrize("which", list(NETS))
def test_flax_params_drive_the_jax_network(which):
    """A port network's weights, carried back as a flax tree, give the JAX
    network the port's outputs."""
    tcls, jcls, args = NETS[which]
    net = init_motion_params(tcls(*args),
                             torch.Generator().manual_seed(5)).eval()
    x, a, e, move = _inputs()
    inputs = {"face_umf": (x, a, e), "mouth_umf": (x, a, move),
              "face_pmf": (x, a, e), "mouth_pmf": (x, a)}[which]
    jnet = jcls(*args, onehot=False)
    tree = TC.flax_params(net)
    jargs = tuple(map(jnp.asarray, inputs))
    assert _shapes(tree) == _shapes(
        jax.eval_shape(jnet.init, jax.random.key(0), *jargs))
    ref = jax.jit(jnet.apply)(tree, *jargs)
    with torch.no_grad():
        out = net(*map(torch.from_numpy, inputs))
    for key, value in ref.items():
        if value is not None:
            np.testing.assert_allclose(out[key].numpy(), np.asarray(value),
                                       rtol=1e-6, atol=1e-6, err_msg=key)


def test_flax_params_inverts_motion_state_dict():
    """Every kernel rank (Dense, Conv1d, Conv2d) goes back to flax's
    layout; other leaves are copied."""
    rng = np.random.default_rng(3)
    tree = {"params": {"dense": {"kernel": rng.normal(size=(5, 7)),
                                 "bias": rng.normal(size=7)},
                       "conv1": {"kernel": rng.normal(size=(3, 4, 6))},
                       "conv2": {"kernel": rng.normal(size=(3, 3, 2, 4))},
                       "grid": {"embeddings": rng.normal(size=(9, 2))}}}
    tree = jax.tree.map(lambda v: v.astype(np.float32), tree)
    back = TC.flax_params(motion_state_dict(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for u, v in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(u, v)
