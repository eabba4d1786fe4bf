"""The port's pre-training CLIs (``instag_torch/cli/pretrain.py``,
``pretrain_face.py``, ``pretrain_mouth.py``) against the JAX package's, on
two generated identities (6 train frames at 64x64, ``variation`` 0.3; 150
face and 100 mouth splats in a capacity of 512, K=256; 6 steps an
identity, which the CLIs' warm-up of 1000 steps an identity holds whole).

  * ``cli.pretrain`` of each package writes bundles whose key paths equal
    the committed manifest (``tests/torch_fixtures/bundle_keys.json``,
    whose ``pretrain_*`` entries the JAX CLI's run regenerates here);
  * the JAX package's ``load_bundle`` and ``state_from_dict`` read the
    port's bundles bit for bit, and the port's ``cli.pretrain_mouth``
    reads the face bundles the JAX CLI wrote (the clouds bit-equal);
  * ``cli.train_face --pretrain_path`` on the port's EMA bundle starts
    from a UMF bit-equal to the EMA;
  * ``--identity_parallel`` is refused by every port CLI.
"""

import json
import os
import pathlib
import shutil

import numpy as np
import jax
import pytest
import torch

from instag_tpu.cli import pretrain as j_pretrain_cli
from instag_tpu.data.synthetic import generate_scene
from instag_tpu.io import checkpoints as JC
from instag_torch.cli import pretrain as t_pretrain_cli
from instag_torch.cli import pretrain_face as t_face_cli
from instag_torch.cli import pretrain_mouth as t_mouth_cli
from instag_torch.cli import train_face as t_train_face_cli
from instag_torch.io import checkpoints as TC
from tests.test_torch_cli import key_paths
from tests.torch_cpu import one_torch_thread  # noqa: F401

IDS = ["id_a", "id_b"]
KEYS = pathlib.Path(__file__).parent / "torch_fixtures" / "bundle_keys.json"
COMMON = ["--init_num", "150", "--mouth_init_num", "100", "--capacity",
          "512", "--max_per_tile", "256", "--iterations", "6"]
# manifest entry -> bundle file in a pretrain run
BUNDLES = {"pretrain_face": "chkpnt_face_latest.pkl",
           "pretrain_ema_face": "chkpnt_ema_face_latest.pkl",
           "pretrain_identity_face": "id_a_face_latest.pkl",
           "pretrain_mouth": "chkpnt_mouth_latest.pkl",
           "pretrain_ema_mouth": "chkpnt_ema_mouth_latest.pkl"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' ``cli.pretrain`` on one root, and the port's
    ``cli.pretrain_mouth`` under the JAX run's face bundles."""
    root = tmp_path_factory.mktemp("pretrain_cli")
    src = str(root / "ids")
    for k, name in enumerate(IDS):
        generate_scene(os.path.join(src, name), n_frames=6, size=64,
                       n_val=2, seed=k, variation=0.3)
    out = {"src": src}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX CLIs point XLA's compile cache at INSTAG_JAX_CACHE
        cache = jax.config.jax_compilation_cache_dir
        min_s = jax.config.jax_persistent_cache_min_compile_time_secs
        mp.setenv("INSTAG_JAX_CACHE", cache or str(root / "jax_cache"))
        out["jax"] = str(root / "jax")
        j_pretrain_cli.main(["-s", src, "-m", out["jax"], "--no_approx_topk",
                             *COMMON])
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_s)
    out["port"] = str(root / "port")
    out["port_res"] = t_pretrain_cli.main(["-s", src, "-m", out["port"],
                                           *COMMON, "--device", "cpu"])
    # the port's mouth stage on the face bundles the JAX CLI wrote
    on_jax = root / "port_mouth_on_jax"
    on_jax.mkdir()
    for f in ["chkpnt_ema_face_latest.pkl"] + [f"{n}_face_latest.pkl"
                                               for n in IDS]:
        shutil.copy(os.path.join(out["jax"], f), on_jax / f)
    out["on_jax"] = str(on_jax)
    out["on_jax_res"] = t_mouth_cli.main(
        ["-s", src, "-m", str(on_jax), "--init_num", "100", "--capacity",
         "512", "--max_per_tile", "256", "--iterations", "6", "--device",
         "cpu"])
    return out


def _keys(run: str) -> dict:
    return {k: key_paths(JC.load_bundle(os.path.join(run, f)))
            for k, f in BUNDLES.items()}


def test_pretrain_bundle_key_manifest(runs):
    """The committed ``pretrain_*`` entries are the JAX CLI's, and the
    port's bundles have the same key paths."""
    jax_keys = _keys(runs["jax"])
    manifest = json.loads(KEYS.read_text())
    assert {k: manifest[k] for k in BUNDLES} == jax_keys
    assert _keys(runs["port"]) == jax_keys
    for k in ("pretrain_mouth", "pretrain_ema_mouth"):
        assert key_paths(JC.load_bundle(os.path.join(
            runs["on_jax"], BUNDLES[k]))) == jax_keys[k]
    for run in (runs["jax"], runs["port"]):
        with open(os.path.join(run, "cfg_args.json")) as f:
            assert json.load(f)["type"] == "face"


def test_jax_reads_port_pretrain_bundles(runs):
    res = runs["port_res"]
    for k, (name, state) in enumerate(zip(IDS, res["face"]["states"])):
        b = JC.load_bundle(os.path.join(runs["port"],
                                        f"{name}_face_latest.pkl"))
        st = JC.state_from_dict(b["state"])
        np.testing.assert_array_equal(np.asarray(st.alive),
                                      state.alive.numpy())
        for f in ("xyz", "features_dc", "opacity", "scaling"):
            np.testing.assert_array_equal(
                np.asarray(getattr(st.params, f)),
                getattr(state.params, f).numpy())
        pmf = TC.flax_params(res["face"]["pmf_nets"][k])
        for a, b_ in zip(jax.tree.leaves(pmf),
                         jax.tree.leaves(b["pmf_params"])):
            np.testing.assert_array_equal(a, np.asarray(b_))
    for branch in ("face", "mouth"):
        ema = JC.load_bundle(os.path.join(
            runs["port"], f"chkpnt_ema_{branch}_latest.pkl"))
        want = TC.flax_params(res[branch]["ema_net"])
        for tree in (ema["umf_params"], ema["ema_params"]):
            for a, b_ in zip(jax.tree.leaves(want), jax.tree.leaves(tree)):
                np.testing.assert_array_equal(a, np.asarray(b_))
        assert JC.bundle_list(ema["data_list"]) == IDS


def test_port_pretrain_mouth_reads_jax_face_bundles(runs):
    face, names = t_mouth_cli.load_face_result(runs["on_jax"], None,
                                               "deepspeech", "cpu")
    assert names == IDS
    for name, st in zip(IDS, face["states"]):
        ref = JC.state_from_dict(JC.load_bundle(os.path.join(
            runs["jax"], f"{name}_face_latest.pkl"))["state"])
        np.testing.assert_array_equal(st.params.xyz.numpy(),
                                      np.asarray(ref.params.xyz))
        np.testing.assert_array_equal(st.alive.numpy(),
                                      np.asarray(ref.alive))
    res = runs["on_jax_res"]
    assert len(res["losses"]) == 12 and np.isfinite(res["losses"]).all()


class _Started(Exception):
    pass


def test_train_face_starts_from_port_ema_bundle(runs, monkeypatch):
    seen = {}

    def train_face(*args, umf_net=None, **kwargs):
        seen["umf"] = umf_net
        raise _Started
    monkeypatch.setattr(t_train_face_cli, "train_face", train_face)
    scene = os.path.join(runs["src"], IDS[0])
    with pytest.raises(_Started):
        t_train_face_cli.main([
            "-s", scene, "--init_num", "150", "--capacity", "512",
            "--pretrain_path", os.path.join(runs["port"],
                                            "chkpnt_ema_face_latest.pkl"),
            "--device", "cpu"])
    ema = runs["port_res"]["face"]["ema_net"].state_dict()
    got = seen["umf"].state_dict()
    assert set(got) == set(ema)
    for k, v in ema.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("cli", [t_pretrain_cli, t_face_cli, t_mouth_cli])
def test_identity_parallel_refused(cli, tmp_path):
    with pytest.raises(SystemExit, match="ROADMAP queue 1, item 7"):
        cli.main(["-s", str(tmp_path), "-m", str(tmp_path),
                  "--identity_parallel", "--device", "cpu"])
