"""The port's workflow scripts (``scripts/torch/``) against the JAX
package's (``scripts/``), without training anything.

Each ``scripts/torch/*.sh`` passes ``bash -n``, names its reference script
in its header, and, run with a stub ``python`` first on ``PATH`` (which
records its arguments and standard input and does nothing else), makes
the same sequence of ``python`` calls as its JAX script, flag for flag,
with ``instag_tpu`` read as ``instag_torch``. The one difference allowed
is ``e2e_from_video.sh``'s capture: the port's ``render_hard_video``
writes ``data/video.avi`` and the script preprocesses the path it
returns, where the JAX script names ``data/video.mp4``. Every
``python -m instag_torch.…`` call names a module that exists, and its
flags parse with that CLI's own parser (``build_parser``).

``scripts/torch/verify_drive.py`` asks for the card by default; on the
CPU its two probes pass and a short fit climbs through the
``keep_slots`` grow (the full 150-step fit runs on the card, in
``chip_smoke.py``)."""

import importlib
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from tests.torch_cpu import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "scripts" / "torch"
SCRIPTS = ["train_few.sh", "train_long.sh", "pretrain_con.sh",
           "process_batch.sh", "e2e_from_video.sh"]
# the positional arguments each script is run with ({d}: a scratch dir)
ARGS = {"train_few.sh": [["{d}/data", "{d}/out"],
                         ["{d}/data", "{d}/out", "{d}/pre", "hubert", "100"]],
        "train_long.sh": [["{d}/data", "{d}/out"],
                          ["{d}/data", "{d}/out", "{d}/pre", "ave"]],
        "pretrain_con.sh": [["{d}/ids", "{d}/out"],
                            ["{d}/ids", "{d}/out", "esperanto"],
                            ["{d}/ids", "{d}/out", "hubert"]],
        "process_batch.sh": [["{d}/ids"], ["{d}/ids", "deepspeech"]],
        "e2e_from_video.sh": [["{d}/e2e", "20", "256", "40"]]}
STUB = '''import json, os, sys
argv = sys.argv[1:]
rec = {"argv": argv, "stdin": sys.stdin.read() if argv[:1] == ["-"] else None}
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(json.dumps(rec) + "\\n")
if argv[:1] == ["-"]:
    # the capture's path, as the port's render_hard_video returns it
    print(os.path.join(argv[1], "data", "video.avi"))
'''


@pytest.fixture(scope="module")
def stub_path(tmp_path_factory):
    """A directory holding a ``python`` that records its calls."""
    d = tmp_path_factory.mktemp("stub")
    (d / "stub.py").write_text(STUB)
    exe = d / "python"
    exe.write_text(f"#!/bin/sh\nexec {sys.executable} {d / 'stub.py'} "
                   f"\"$@\"\n")
    exe.chmod(0o755)
    return d


def _calls(script: pathlib.Path, args: list, stub_path, work) -> list:
    """The ``python`` calls ``script`` makes with ``args``, with the
    scratch directory written as ``{d}``."""
    work.mkdir(exist_ok=True)
    d = str(work)
    (work / "ids" / "id_a").mkdir(parents=True, exist_ok=True)
    (work / "ids" / "id_a" / "id_a.mp4").write_bytes(b"")
    (work / "e2e" / "out").mkdir(parents=True, exist_ok=True)
    (work / "e2e" / "out" / "metrics.json").write_text("{}")
    log = work / "calls.jsonl"
    log.write_text("")
    env = dict(os.environ, PATH=f"{stub_path}{os.pathsep}{os.environ['PATH']}",
               STUB_LOG=str(log))
    res = subprocess.run(["bash", str(script), *(a.format(d=d) for a in args)],
                         cwd=work, env=env, capture_output=True, text=True,
                         timeout=60)
    assert res.returncode == 0, res.stdout + res.stderr
    calls = [json.loads(x) for x in log.read_text().splitlines()]
    for c in calls:
        c["argv"] = [a.replace(d, "{d}") for a in c["argv"]]
    return calls


@pytest.mark.parametrize("name", SCRIPTS)
def test_script_parses_and_names_its_reference(name):
    path = PORT / name
    res = subprocess.run(["bash", "-n", str(path)], capture_output=True,
                         text=True, timeout=30)
    assert res.returncode == 0, res.stderr
    head = path.read_text().split("set -euo pipefail")[0]
    assert f"counterpart of scripts/{name}" in " ".join(head.split())
    assert "set -euo pipefail" in path.read_text()
    assert os.access(path, os.X_OK)


@pytest.mark.parametrize("name,args", [(n, a) for n in SCRIPTS
                                       for a in ARGS[n]])
def test_stages_and_flags_equal_the_jax_scripts(name, args, stub_path,
                                                tmp_path):
    ours = _calls(PORT / name, args, stub_path, tmp_path / "port")
    ref = _calls(ROOT / "scripts" / name, args, stub_path, tmp_path / "jax")
    assert ours and len(ours) == len(ref)

    def as_port(arg: str) -> str:
        arg = arg.replace("instag_tpu", "instag_torch")
        # the one difference: the port's capture is the renderer's AVI
        return ("{d}/e2e/data/video.avi" if arg == "{d}/e2e/data/video.mp4"
                else arg)
    for o, r in zip(ours, ref):
        assert o["argv"] == [as_port(a) for a in r["argv"]]
        if r["stdin"] is not None:
            # the render stage: the same call, printing only the path
            keep = lambda s: [x for x in s.splitlines()  # noqa: E731
                              if not x.startswith("print(")]
            assert keep(o["stdin"]) == keep(as_port(r["stdin"]))


@pytest.mark.parametrize("name,args", [(n, a) for n in SCRIPTS
                                       for a in ARGS[n]])
def test_port_modules_exist_and_parse_their_flags(name, args, stub_path,
                                                  tmp_path):
    calls = _calls(PORT / name, args, stub_path, tmp_path)
    for c in calls:
        argv = c["argv"]
        if argv[0] == "-":
            code = c["stdin"]
            compile(code, name, "exec")
            assert "from instag_torch.data.synthetic_hard import " \
                "render_hard_video" in code
            assert "instag_tpu" not in code and "jax" not in code
            continue
        assert argv[0] == "-m" and argv[1].startswith("instag_torch."), argv
        assert importlib.util.find_spec(argv[1]) is not None, argv[1]
        mod = importlib.import_module(argv[1])
        args_ = mod.build_parser().parse_args(
            [a.replace("{d}", str(tmp_path)) for a in argv[2:]])
        assert getattr(args_, "device", "cuda") == "cuda"


def _verify_drive():
    spec = importlib.util.spec_from_file_location(
        "verify_drive", PORT / "verify_drive.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_verify_drive_defaults_to_the_card(monkeypatch):
    vd = _verify_drive()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vd.main([])


def test_verify_drive_probes_on_the_cpu():
    vd = _verify_drive()
    cpu = torch.device("cpu")
    vd.behind_camera_probe(cpu)
    vd.hashgrid_oob_probe(cpu)
    # a short fit: the grow leaves the render as it was, and the PSNR climbs
    p0, p1 = vd.fit(cpu, steps=3)
    assert p1 > p0
