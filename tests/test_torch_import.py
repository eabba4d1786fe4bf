"""The PyTorch port stands alone: it imports neither JAX (nor flax, optax
or the msgpack package) nor the JAX package, and its entry points never
fall back from CUDA to the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from tests.torch_cpu import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "instag_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "instag_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _fresh_codes() -> dict:
    """The code each fresh-process import check runs."""
    return {
        "all": ("import importlib, sys\n"
                f"for m in {list(_modules())!r}:\n"
                "    importlib.import_module(m)\n"
                f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
                "assert not bad, bad\n"
                "print('ok', len(sys.modules))\n"),
        "static": ("import importlib, sys\n"
                   f"for m in {['instag_torch.train.static'] + NEW_MODULES!r}:\n"
                   "    importlib.import_module(m)\n"
                   f"    bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
                   "    assert not bad, (m, bad)\n"),
        "extractors": ("import importlib, sys\n"
                       "sys.modules['cv2'] = None\n"
                       f"for m in {EXTRACTOR_MODULES!r}:\n"
                       "    importlib.import_module(m)\n"
                       f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
                       "assert not bad, bad\n")}


@pytest.fixture(scope="module")
def fresh_imports(tmp_path_factory):
    """Each check of ``_fresh_codes`` in a fresh process, all started at
    once (each spends its seconds importing torch): {name: (return code,
    output)}."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = tmp_path_factory.mktemp("fresh_imports")
    procs = {}
    for name, code in _fresh_codes().items():
        log = open(out / f"{name}.log", "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", code], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT, text=True), log)
    done = {}
    for name, (proc, log) in procs.items():
        try:
            proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log.seek(0)
        done[name] = (proc.returncode, log.read())
        log.close()
    return done


def test_import_leaves_jax_out_of_sys_modules(fresh_imports):
    code, out = fresh_imports["all"]
    assert code == 0, out
    assert out.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]
    + [str(p.relative_to(ROOT))
       for p in (ROOT / "scripts" / "torch").glob("*.py")]))
def test_source_imports_nothing_of_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_cuda_device_without_gpu_raises(monkeypatch, tmp_path):
    from instag_torch import bench_utils
    from instag_torch.cli import synthesize_fuse
    from instag_torch.config import ModelConfig, OptimizationConfig
    from instag_torch.data.dataset import load_frames
    from instag_torch.data.synthetic import generate_scene
    from instag_torch.io.checkpoints import load_gaussian_ply, state_from_dict
    from instag_torch.ops.rasterize import RasterizeConfig
    from instag_torch.synthesize import make_synthesis_fn, synthesize
    from instag_torch.train.pretrain import pretrain_face

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_utils.synthetic_state(10, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_utils.synthetic_camera(32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_synthesis_fn(RasterizeConfig(32, 32))
    for call in (lambda: load_frames(str(tmp_path)),
                 lambda: generate_scene(str(tmp_path / "scene")),
                 lambda: state_from_dict({}),
                 lambda: load_gaussian_ply(str(tmp_path / "a.ply"), 8),
                 lambda: synthesize(ModelConfig(), None),
                 lambda: synthesize_fuse.load_fuse_model(str(tmp_path)),
                 lambda: synthesize_fuse.main(["-m", str(tmp_path)]),
                 lambda: pretrain_face(ModelConfig(), OptimizationConfig(),
                                       ["a"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not (tmp_path / "scene").exists()


def test_approx_topk_is_refused():
    from instag_torch.ops.rasterize import RasterizeConfig

    assert RasterizeConfig(32, 32).approx_topk is False
    with pytest.raises(ValueError, match="approx"):
        RasterizeConfig(32, 32, approx_topk=True)


@pytest.mark.parametrize("name", ["train_face", "train_mouth",
                                  "train_fuse_con", "adapt", "pretrain",
                                  "pretrain_face", "pretrain_mouth"])
def test_adaptation_clis_default_to_the_card(name, monkeypatch, tmp_path):
    """Without ``--device cpu`` each adaptation or pre-training CLI asks
    for the card, and
    raises before it reads or writes anything where there is none."""
    import importlib

    cli = importlib.import_module(f"instag_torch.cli.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-s", str(tmp_path / "scene"), "-m",
                  str(tmp_path / "run")])
    assert not (tmp_path / "run").exists()


NEW_MODULES = ["instag_torch.ops.freq", "instag_torch.ops.encoding",
               "instag_torch.ops.reference_splat",
               "instag_torch.models.grid_renderer",
               "instag_torch.io.reference_convert",
               "instag_torch.train.static", "instag_torch.cli.metrics",
               "instag_torch.cli.auerror",
               "instag_torch.data.synthetic_hard"]


def test_static_slice_modules_load_no_jax(fresh_imports):
    """The modules of the static-training slice are in the source scan,
    and ``import instag_torch.train.static`` in a fresh process, then the
    slice's other modules, load no JAX."""
    assert set(NEW_MODULES) <= set(_modules())
    code, out = fresh_imports["static"]
    assert code == 0, out


def test_static_slice_entry_points_default_to_the_card(monkeypatch,
                                                       tmp_path):
    """Without a card, the static trainer, its CLI, the hard scene writer
    and the metrics CLI raise before they read or write anything."""
    from instag_torch.cli import metrics
    from instag_torch.config import ModelConfig, OptimizationConfig
    from instag_torch.data.synthetic_hard import generate_hard_scene
    from instag_torch.train import static

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: static.train(ModelConfig(), OptimizationConfig()),
                 lambda: static.main(["-s", str(tmp_path / "scene"), "-m",
                                      str(tmp_path / "run")]),
                 lambda: generate_hard_scene(str(tmp_path / "hard")),
                 lambda: metrics.main(["--pred", "a.npz", "--gt", "b.npz"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not any(tmp_path.iterdir())


EXTRACTOR_MODULES = ["instag_torch.data_utils." + m for m in (
    "cv_ops", "face_model", "mesh_render", "photometric", "tracker",
    "landmarks", "face_parsing", "easyportrait_fpn", "priors", "process")]


def test_preprocessing_modules_load_without_jax_or_opencv(fresh_imports):
    """The photometric fit's and the learned extractors' modules are in the
    source scan, and load in a fresh process where OpenCV cannot import,
    with no JAX."""
    assert set(EXTRACTOR_MODULES) <= set(_modules())
    code, out = fresh_imports["extractors"]
    assert code == 0, out


def test_preprocessing_entry_points_default_to_the_card(monkeypatch,
                                                        tmp_path):
    """Without a card the fit, the tracker with a model, the extractors and
    their process tasks raise before they read or write anything."""
    import numpy as np

    from instag_torch.data_utils import (face_parsing, landmarks,
                                         photometric, priors, process,
                                         tracker)
    from instag_torch.data_utils.face_model import synthetic_model
    from instag_torch.metrics import track_video_landmarks

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = tmp_path / "scene"
    model = synthetic_model()
    z = np.zeros((2, 3), np.float32)
    for call in (
            lambda: photometric.fit_photometric(
                model, np.zeros((2, 68, 2)), np.zeros((2, 16, 16, 3)), 10.0,
                8.0, 8.0, z, z),
            lambda: tracker.track_poses(str(base), str(base), model=model),
            lambda: landmarks.LandmarkTracker(),
            lambda: landmarks.load_fan("absent.pth"),
            lambda: face_parsing.run_parsing(str(base), str(base)),
            lambda: priors.create_teeth_masks(str(base), str(base)),
            lambda: priors.run_sapiens(str(base)),
            lambda: track_video_landmarks(np.zeros((1, 8, 8, 3))),
            *(lambda t=t: process.main([str(base / "v.avi"), "--task", t])
              for t in ("4", "7", "8", "11", "12"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not any(tmp_path.iterdir())
