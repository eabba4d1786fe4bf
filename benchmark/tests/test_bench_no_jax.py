"""Nothing the benchmark runs loads JAX or the JAX package: the check
compares each loaded module's top-level name whole, the harness's sources
import neither, and the references import nothing of the program."""

import ast
import os
import sys
import time
import types

import pytest

from conftest import HERE, tiny_tree

from benchmark import run
from benchmark.worker import forbidden_modules


def test_top_level_names_are_compared_whole(monkeypatch):
    for name in ("instag_torch.kernels", "instag_tpu_extra", "jaxtyping",
                 "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert not {"instag_tpu", "jax", "flax"} & set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "instag_tpu.ops",
                        types.ModuleType("instag_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    assert {"instag_tpu", "jax"} <= set(forbidden_modules())


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax_and_the_references_none_of_the_program():
    for d, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(d, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not tops & {"jax", "jaxlib", "flax", "instag_tpu"}, path
            if f in ("reference.py", "reference_train.py", "gen.py",
                     "counts.py"):
                assert "instag_torch" not in tops, path


def test_a_run_with_jax_loaded_is_refused(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    root, here = tiny_tree(tmp_path)
    with pytest.raises(run.Refused):
        run.run_cell("tiny.clip", 3, 1.0, False, device="cpu", spawn=False,
                     root=root, here=here, t_start=time.monotonic())
