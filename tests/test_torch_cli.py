"""The port's adaptation CLIs (``instag_torch/cli/train_face.py``,
``train_mouth.py``, ``train_fuse_con.py``) against the JAX package's, on a
generated scene (8 train and 2 val frames at 64x64; 200 initial splats in
a capacity of 1024, K=256 so that no tile is cut; densification interval 5;
LPIPS from both packages' one ``.npz`` of the JAX package's seed-0
random-feature parameters).

The JAX CLIs initialise their nets with flax from ``jax.random.key(seed)``,
which the port cannot draw, so parity runs through resume: the JAX face
CLI trains 10 steps, and both packages' CLIs resume its bundle to 25 steps
(JAX to port); the port's face CLI also trains 10 steps, whose log is held
against the JAX run's. The mouth runs in a directory holding the port's
10-step face bundle: the port's mouth CLI trains 10 steps on it, and both
packages resume that bundle to 25 (port to JAX). Both fusion CLIs then run
10 steps (LPIPS from step 6) on the port's face bundle and the port's
resumed mouth bundle, and the port's fusion CLI also runs on the two
bundles the JAX package resumed. Densification starts 1000
steps before the end of a run, so none of these runs densifies. The val
reporter, on in every face run with a model path, is held against the JAX
reporter on one state.

Tolerances: per-step losses within rtol 1e-3 (see
tests/test_torch_train_face.py) and final alive masks equal; reporter
scores within rtol 1e-4, its panel within one level, ``metrics.jsonl``'s
tags and keys equal; each bundle's key paths equal to the JAX CLI's
(``tests/torch_fixtures/bundle_keys.json``).
"""

import json
import os
import pathlib
import shutil
import warnings

import numpy as np
import jax
import pytest
from PIL import Image

import instag_tpu.cli.train_face as j_face_cli
import instag_tpu.cli.train_fuse_con as j_fuse_cli
import instag_tpu.cli.train_mouth as j_mouth_cli
import instag_tpu.models.lpips as JL
from instag_tpu.data.dataset import load_frames as j_load_frames
from instag_tpu.data.synthetic import generate_scene
from instag_tpu.io import checkpoints as JC
from instag_tpu.models import motion as JM
from instag_tpu.ops.rasterize import RasterizeConfig as JConfig
from instag_tpu.train import common as j_common
from instag_tpu.train.report import FaceValReporter as JReporter
from instag_torch.cli import train_face as t_face_cli
from instag_torch.cli import train_fuse_con as t_fuse_cli
from instag_torch.cli import train_mouth as t_mouth_cli
from instag_torch.data.image_io import read_png
from instag_torch.io import checkpoints as TC
from instag_torch.io.from_jax import frame_batch
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.train.report import FaceValReporter
from tests.torch_cpu import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent
KEYS = ROOT / "torch_fixtures" / "bundle_keys.json"
LOSS_RTOL = 1e-3
COMMON = ["--init_num", "200", "--capacity", "1024", "--max_per_tile", "256",
          "--densification_interval", "5"]


def key_paths(tree, prefix=""):
    """A bundle's key paths, sorted; an empty map ends in '/'."""
    if isinstance(tree, dict):
        if not tree:
            return [prefix + "/"]
        return sorted(p for k, v in tree.items()
                      for p in key_paths(v, f"{prefix}/{k}"))
    return [prefix]


def _record(mp, module, name):
    """Keep the results of ``module.name`` (a JAX CLI's trainer)."""
    seen, fn = [], getattr(module, name)

    def wrapper(*args, **kwargs):
        seen.append(fn(*args, **kwargs))
        return seen[-1]
    mp.setattr(module, name, wrapper)
    return seen


def _copy(src, dst, *names):
    os.makedirs(dst, exist_ok=True)
    for n in names:
        shutil.copy(os.path.join(src, n), os.path.join(dst, n))
    return str(dst)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every CLI run of the module: {name: (model dir, result)}."""
    root = tmp_path_factory.mktemp("cli")
    scene = str(root / "scene")
    generate_scene(scene, n_frames=8, size=64, n_val=2)
    with pytest.MonkeyPatch.context() as mp:
        # the JAX CLIs point XLA's compile cache at INSTAG_JAX_CACHE
        cache = jax.config.jax_compilation_cache_dir
        min_s = jax.config.jax_persistent_cache_min_compile_time_secs
        mp.setenv("INSTAG_JAX_CACHE", cache or str(root / "jax_cache"))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mp.setenv("INSTAG_LPIPS_WEIGHTS", str(root / "absent.npz"))
            _, params, _ = JL.load_lpips_params()
        p = jax.device_get(params)["params"]
        npz = str(root / "lpips_alex.npz")
        np.savez(npz, **{k: np.asarray(v) for i in range(5) for k, v in (
            (f"conv_{i}_w", p["alex"][f"conv_{i}"]["kernel"]),
            (f"conv_{i}_b", p["alex"][f"conv_{i}"]["bias"]),
            (f"lin_{i}", p[f"lin_{i}"]))})
        mp.setenv("INSTAG_LPIPS_WEIGHTS", npz)
        j_face = _record(mp, j_face_cli, "train_face")
        j_mouth = _record(mp, j_mouth_cli, "train_mouth")
        j_fuse = _record(mp, j_fuse_cli, "train_fuse")

        def jax_cli(cli, model_dir, *args):
            cli.main(["-s", scene, "-m", str(model_dir), "--no_approx_topk",
                      *COMMON, *args])

        def port_cli(cli, model_dir, *args):
            return cli.main(["-s", scene, "-m", str(model_dir), *COMMON,
                             "--device", "cpu", *args])

        out = {"scene": scene}
        # face: JAX 10 steps; both resume its bundle to 25
        jf = root / "jax_face"
        jax_cli(j_face_cli, jf, "--iterations", "10")
        out["jax_face"] = (str(jf), j_face[-1])
        start = ["--iterations", "25", "--start_checkpoint",
                 str(jf / "chkpnt_face_latest.pkl")]
        jax_cli(j_face_cli, root / "jax_face_25", *start)
        out["jax_face_25"] = (str(root / "jax_face_25"), j_face[-1])
        out["port_face_25"] = (str(root / "port_face_25"), port_cli(
            t_face_cli, root / "port_face_25", *start))
        pf = root / "port_face"
        out["port_face"] = (str(pf), port_cli(t_face_cli, pf, "--iterations",
                                              "10"))
        # mouth, under the port's face bundle: the port 10 steps; both
        # resume its bundle to 25
        out["port_mouth"] = (str(pf), port_cli(t_mouth_cli, pf,
                                               "--iterations", "10"))
        start = ["--iterations", "25", "--start_checkpoint",
                 str(pf / "chkpnt_mouth_latest.pkl")]
        jm = _copy(pf, root / "jax_mouth_25", "chkpnt_face_latest.pkl")
        jax_cli(j_mouth_cli, jm, *start)
        out["jax_mouth_25"] = (jm, j_mouth[-1])
        tm = _copy(pf, root / "port_mouth_25", "chkpnt_face_latest.pkl")
        out["port_mouth_25"] = (tm, port_cli(t_mouth_cli, tm, *start))
        # fusion on the port's face and resumed mouth bundles
        both = ("chkpnt_face_latest.pkl", "chkpnt_mouth_latest.pkl")
        jz = _copy(tm, root / "jax_fuse", *both)
        jax_cli(j_fuse_cli, jz, "--iterations", "10")
        out["jax_fuse"] = (jz, j_fuse[-1])
        tz = _copy(tm, root / "port_fuse", *both)
        out["port_fuse"] = (tz, port_cli(t_fuse_cli, tz, "--iterations",
                                         "10"))
        # the port's fusion on the bundles the JAX package resumed
        jj = _copy(str(root / "jax_face_25"), root / "port_fuse_on_jax",
                   "chkpnt_face_latest.pkl")
        shutil.copy(os.path.join(jm, both[1]), os.path.join(jj, both[1]))
        out["port_fuse_on_jax"] = (jj, port_cli(t_fuse_cli, jj,
                                                "--iterations", "10"))
        jax.config.update("jax_compilation_cache_dir", cache)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", min_s)
        yield out


def _bundle(runs, name, which):
    return JC.load_bundle(os.path.join(runs[name][0],
                                       f"chkpnt_{which}_latest.pkl"))


@pytest.mark.parametrize("which", ["face", "mouth"])
def test_resumed_cli_runs_match_jax(runs, which):
    ref, ours = runs[f"jax_{which}_25"][1], runs[f"port_{which}_25"][1]
    assert len(ours["losses"]) == len(ref["losses"]) == 15
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=LOSS_RTOL)
    np.testing.assert_array_equal(ours["state"].alive.numpy(),
                                  np.asarray(ref["state"].alive))
    # the bundles carry the schedule on from the resumed count
    for name in (f"jax_{which}_25", f"port_{which}_25"):
        b = _bundle(runs, name, which)
        assert b["iteration"] == 25 and int(b["gopt"]["step"]) == 25
        umf = b["umf_opt_state"]["inner_states"]["net"]["inner_state"]
        assert int(umf["0"]["count"]) == int(umf["2"]["count"]) == 25


def test_fuse_cli_matches_jax(runs):
    ref, ours = runs["jax_fuse"][1], runs["port_fuse"][1]
    assert len(ours["losses"]) == 10
    np.testing.assert_allclose(ours["losses"], ref["losses"], rtol=LOSS_RTOL)
    assert np.isfinite(runs["port_fuse_on_jax"][1]["losses"]).all()


def test_bundles_read_across_packages(runs):
    """The JAX CLIs read the port's face and mouth bundles to resume the
    mouth and to fuse; the port read the JAX face bundle to resume and the
    JAX face and mouth bundles to fuse. Each bundle, read by the other
    package, holds the writer's cloud."""
    for name, which in (("port_face", "face"), ("port_mouth", "mouth"),
                        ("port_mouth_25", "mouth"), ("jax_face", "face"),
                        ("jax_face_25", "face"), ("jax_mouth_25", "mouth")):
        path = os.path.join(runs[name][0], f"chkpnt_{which}_latest.pkl")
        res = runs[name][1]
        st = (TC.load_branch(path, which, device="cpu")["state"]
              if name.startswith("jax") else JC.state_from_dict(
                  JC.load_bundle(path)["state"]))
        np.testing.assert_array_equal(np.asarray(st.params.xyz),
                                      np.asarray(res["state"].params.xyz))
    assert runs["jax_mouth_25"][1]["losses"] and runs["jax_fuse"][1]["losses"]


def test_bundle_key_manifest(runs):
    """The committed manifest's face, mouth and fuse entries are the JAX
    CLIs' (regenerated here; its pre-training entries are
    tests/test_torch_pretrain_cli.py's), and every port bundle has their
    key paths."""
    jax_keys = {w: key_paths(_bundle(runs, n, w)) for w, n in (
        ("face", "jax_face"), ("mouth", "jax_mouth_25"),
        ("fuse", "jax_fuse"))}
    manifest = json.loads(KEYS.read_text())
    assert {w: manifest[w] for w in jax_keys} == jax_keys
    for w, names in (("face", ("port_face", "port_face_25")),
                     ("mouth", ("port_mouth", "port_mouth_25")),
                     ("fuse", ("port_fuse", "port_fuse_on_jax"))):
        for n in names:
            assert key_paths(_bundle(runs, n, w)) == jax_keys[w], n


def test_cli_artifacts_and_reporter_logs(runs):
    for name, it in (("jax_face", 10), ("port_face", 10),
                     ("jax_face_25", 25), ("port_face_25", 25)):
        d = pathlib.Path(runs[name][0])
        assert json.loads((d / "cfg_args.json").read_text())["type"] == "face"
        assert (d / "point_cloud" / f"iteration_{it}_face" /
                "point_cloud.ply").exists()
        assert (d / "val_renders" / f"val_{it}.png").exists()
    assert (pathlib.Path(runs["port_mouth_25"][0]) / "point_cloud" /
            "iteration_25_mouth" / "point_cloud.ply").exists()

    def tags(name):
        path = pathlib.Path(runs[name][0]) / "metrics.jsonl"
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        return sorted({(r["tag"], r["step"], tuple(sorted(r)))
                       for r in lines})
    assert tags("port_face") == tags("jax_face")
    assert tags("port_face_25") == tags("jax_face_25")
    assert ("iter_time_ms", 10, ("step", "t", "tag", "value")) in \
        tags("port_face")


def test_val_reporter_matches_jax(runs, tmp_path):
    """Both reporters on the JAX face bundle's state and nets."""
    scene = runs["scene"]
    b = _bundle(runs, "jax_face", "face")
    j_state = JC.state_from_dict(b["state"])
    batches = []
    for split in ("val", "train"):
        jb = j_common.build_frame_batch(j_load_frames(scene, split))
        batches.append((jb, frame_batch(
            {k: None if v is None else np.asarray(v)
             for k, v in vars(jb).items()}, device="cpu")))
    (j_val, t_val), (j_train, t_train) = batches
    j_rep = JReporter(JConfig(64, 64, max_per_tile=256, approx_topk=False),
                      JM.MotionNetwork(), JM.PersonalizedMotionNetwork("face"),
                      j_val, j_train, str(tmp_path / "jax"))
    ref = j_rep(10, j_state, b["umf_params"], b["pmf_params"])
    branch = TC.load_branch(os.path.join(runs["jax_face"][0],
                                         "chkpnt_face_latest.pkl"), "face",
                            device="cpu")
    t_rep = FaceValReporter(RasterizeConfig(64, 64, max_per_tile=256), t_val,
                            t_train, str(tmp_path / "port"))
    ours = t_rep(10, branch["state"], branch["umf_net"], branch["pmf_net"])
    assert set(ours) == set(ref) == {"val_l1", "val_psnr", "val_tile_sat_max",
                                     "train_l1", "train_psnr"}
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-4), k
    for name in ("val", "train"):
        a = read_png(str(tmp_path / "port" / "val_renders" /
                         f"{name}_10.png"), channels=3)
        want = np.asarray(Image.open(tmp_path / "jax" / "val_renders" /
                                     f"{name}_10.png"))
        assert a.shape == want.shape == (64, 8 * 64, 3)
        assert np.abs(a.astype(int) - want.astype(int)).max() <= 1, name
    j_lines, t_lines = ([json.loads(x) for x in (tmp_path / d /
                                                 "metrics.jsonl").read_text(
                                                     ).splitlines()]
                        for d in ("jax", "port"))
    assert [sorted(r) for r in t_lines] == [sorted(r) for r in j_lines]
    assert [r["tag"] for r in t_lines] == [r["tag"] for r in j_lines]
    for r, s in zip(t_lines, j_lines):
        for k in ("value", "mean", "p5", "p50", "p95"):
            if k in r:
                assert r[k] == pytest.approx(s[k], rel=1e-4, abs=1e-6), k
