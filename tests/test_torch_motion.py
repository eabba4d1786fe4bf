"""The port's hash grids, audio nets and motion fields against the JAX
package on the same weights, carried across by instag_torch/io/from_jax.py.

The flax parameter trees are drawn with numpy in the layout flax expects
(checked against ``jax.eval_shape`` of the flax init), applied by the JAX
modules, and loaded into the port through ``from_jax``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from instag_tpu.models import motion as JM
from instag_tpu.models import nets as JN
from instag_tpu.ops import hashgrid as JH
from instag_torch.io.from_jax import load_motion_net
from instag_torch.models import motion as TM
from instag_torch.models import nets as TN
from instag_torch.ops import hashgrid as TH
from tests.torch_cpu import one_torch_thread  # noqa: F401


def flax_tree(net: torch.nn.Module, rng, emb_scale=0.3):
    """Random numpy params shaped as the flax tree of ``net``'s twin."""
    tree = {}
    for name, p in net.named_parameters():
        *path, leaf = name.split(".")
        shape = tuple(p.shape)
        if leaf == "embeddings":
            value = rng.uniform(-emb_scale, emb_scale, shape)
        elif leaf == "bias":
            value = rng.normal(0.0, 0.1, shape)
        else:
            fan_in = int(np.prod(shape[1:]))
            value = rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
            value = value.transpose(2, 1, 0) if value.ndim == 3 else value.T
            leaf = "kernel"
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.astype(np.float32)
    return {"params": tree}


def _shapes(tree):
    return jax.tree.map(lambda v: tuple(np.shape(v)), tree)


def _inputs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.17, 0.17, (n, 3)).astype(np.float32)  # some OOB
    a = rng.normal(size=(8, 29, 16)).astype(np.float32)
    e = np.abs(rng.normal(0.3, 0.2, 6)).astype(np.float32)
    move = np.array([[0.6, -0.4, 1.0]], np.float32)
    return x, a, e, move


@pytest.mark.parametrize("cfg", [
    JH.triplane_configs(16, 256 * 0.15),            # face tri-plane: dense
    JH.triplane_configs(64, 384 * 0.15),            # mouth tri-plane: dense
    JH.HashGridConfig(input_dim=2, num_levels=4, level_dim=2,
                      base_resolution=8, per_level_scale=2.0,
                      log2_hashmap_size=6),         # levels 2-3 hash
    JH.HashGridConfig(input_dim=3, num_levels=3, level_dim=2,
                      base_resolution=4, log2_hashmap_size=7,
                      interpolation="smoothstep"),  # 3-D, dense and hashed
], ids=["face", "mouth", "hash2d", "hash3d"])
def test_hashgrid_encode_matches_jax(cfg):
    tcfg = TH.HashGridConfig(
        input_dim=cfg.input_dim, num_levels=cfg.num_levels,
        level_dim=cfg.level_dim, per_level_scale=cfg.per_level_scale,
        base_resolution=cfg.base_resolution,
        log2_hashmap_size=cfg.log2_hashmap_size,
        interpolation=cfg.interpolation)
    np.testing.assert_array_equal(TH.level_offsets(tcfg)[0],
                                  cfg.level_offsets()[0])
    statics = [TH._level_static(tcfg, l) for l in range(cfg.num_levels)]
    assert statics == [JH._level_static(cfg, l)
                       for l in range(cfg.num_levels)]
    rng = np.random.default_rng(1)
    emb = rng.uniform(-1, 1, (cfg.total_params(), cfg.level_dim)).astype(np.float32)
    x = rng.uniform(-1.1, 1.1, (300, cfg.input_dim)).astype(np.float32)
    ref = np.asarray(JH.hashgrid_encode_jit(cfg, jnp.asarray(emb),
                                            jnp.asarray(x)))
    out = TH.hashgrid_encode(tcfg, torch.from_numpy(emb), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    if cfg.log2_hashmap_size < 8:
        assert any(s[3] for s in statics)           # the hash is exercised


def test_audio_nets_match_jax():
    rng = np.random.default_rng(2)
    x, a, _, _ = _inputs()
    for jnet, tnet, inp in [
            (JN.AudioNet(29, 32), TN.AudioNet(29, 32), a),
            (JN.AudioAttNet(32), TN.AudioAttNet(32),
             rng.normal(size=(1, 8, 32)).astype(np.float32)),
            (JN.AudioNetAVE(32), TN.AudioNetAVE(32),
             rng.normal(size=(8, 1, 512)).astype(np.float32))]:
        params = flax_tree(tnet, rng)
        assert _shapes(params) == _shapes(
            jax.eval_shape(jnet.init, jax.random.key(0), jnp.asarray(inp)))
        ref = np.asarray(jnet.apply(params, jnp.asarray(inp)))
        load_motion_net(tnet, params, device="cpu")
        with torch.no_grad():
            out = tnet(torch.from_numpy(inp)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)


def _nets():
    x, a, e, move = _inputs()
    return [
        ("face_umf", JM.MotionNetwork(onehot=False), TM.MotionNetwork(),
         (x, a, e)),
        ("mouth_umf", JM.MouthMotionNetwork(onehot=False),
         TM.MouthMotionNetwork(), (x, a, move)),
        ("face_pmf", JM.PersonalizedMotionNetwork("face", onehot=False),
         TM.PersonalizedMotionNetwork("face"), (x, a, e)),
        ("mouth_pmf", JM.PersonalizedMotionNetwork("mouth", onehot=False),
         TM.PersonalizedMotionNetwork("mouth"), (x, a)),
    ]


@pytest.mark.parametrize("which", range(4),
                         ids=["face_umf", "mouth_umf", "face_pmf", "mouth_pmf"])
def test_motion_net_matches_jax(which):
    _, jnet, tnet, args = _nets()[which]
    params = flax_tree(tnet, np.random.default_rng(10 + which))
    jargs = tuple(map(jnp.asarray, args))
    assert _shapes(params) == _shapes(
        jax.eval_shape(jnet.init, jax.random.key(0), *jargs))
    ref = jax.jit(jnet.apply)(params, *jargs)
    load_motion_net(tnet, params, device="cpu")
    with torch.no_grad():
        out = tnet(*map(torch.from_numpy, args))
    assert set(out) == set(ref)
    for key, value in ref.items():
        if value is None:
            assert out[key] is None, key
            continue
        value = np.asarray(value)
        assert float(np.abs(value).max()) > 0.0, key
        np.testing.assert_allclose(out[key].numpy(), value, atol=1e-5,
                                   err_msg=key)
