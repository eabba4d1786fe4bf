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


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import importlib, sys\n"
            f"for m in {list(_modules())!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")] + ["chip_smoke.py"]))
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
