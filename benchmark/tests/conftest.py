"""The benchmark's own tests (``python -m pytest benchmark/tests``): on the
CPU at tiny sizes, and marked ``cuda`` where they need the card. The tiny
cells live in a temporary copy of the benchmark's data files."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
HERE = os.path.join(ROOT, "benchmark")


@pytest.fixture
def card():
    """Skip unless a CUDA card is here (decided when the test runs)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


def tiny_tree(tmp, clients=2, adapt_clients=1):
    """A root with a BENCHMARK.json of two tiny cells (64 px) and a copy of
    the benchmark's data files; returns (root, here)."""
    here = os.path.join(tmp, "benchmark")
    for d in ("traffic", "metrics", "limits", "configs"):
        shutil.copytree(os.path.join(HERE, d), os.path.join(here, d))
    cfg = json.load(open(os.path.join(HERE, "configs", "instag-few-ds.json")))
    cfg.update(name="tiny", image_size=64, init_num=100, capacity=1024)
    cfg["face"].update(live=300, capacity=512)
    cfg["mouth"].update(live=100, capacity=256)
    cfg["camera"]["focal"] = 150.0
    json.dump(cfg, open(os.path.join(here, "configs", "tiny.json"), "w"))
    clip = json.load(open(os.path.join(HERE, "traffic", "clip-streams.json")))
    clip.update(clients=clients, frames=8, fetch_window=8,
                samples_per_client=2)
    json.dump(clip, open(os.path.join(here, "traffic", "tiny-clip.json"), "w"))
    adapt = json.load(open(os.path.join(HERE, "traffic",
                                        "adapt-jobs-start.json")))
    adapt.update(clients=adapt_clients, frames=8)
    json.dump(adapt, open(os.path.join(here, "traffic", "tiny-adapt.json"),
                          "w"))
    for cell in ("tiny.clip", "tiny.adapt"):
        src = "few-ds.clip-streams" if cell == "tiny.clip" \
            else "few-ds.adapt-jobs"
        shutil.copy(os.path.join(HERE, "limits", f"{src}.json"),
                    os.path.join(here, "limits", f"{cell}.json"))
    bench = dict(
        configs=[dict(name="tiny", file="benchmark/configs/tiny.json")],
        workloads=[dict(name="tiny.clip", config="tiny", traffic="tiny-clip",
                        chips=1),
                   dict(name="tiny.adapt", config="tiny",
                        traffic="tiny-adapt", chips=1)],
        end_to_end=[dict(name="clip_fps", unit="frames/s"),
                    dict(name="adapt_steps_per_s", unit="steps/s"),
                    dict(name="setup_s", unit="s")],
        per_layer=[])
    json.dump(bench, open(os.path.join(tmp, "BENCHMARK.json"), "w"))
    return str(tmp), here
