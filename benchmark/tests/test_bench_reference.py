"""The plain references against the program on the CPU at tiny sizes, and
(on the card) the control, which has to read above each cell's limit."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import HERE, ROOT

from benchmark import gen, reference, reference_train
from benchmark.drivers import clip

CFG = json.load(open(os.path.join(HERE, "configs", "instag-few-ds.json")))
TRAFFIC = json.load(open(os.path.join(HERE, "traffic", "clip-streams.json")))


def _tiny():
    cfg = json.loads(json.dumps(CFG))
    cfg.update(image_size=64)
    cfg["face"].update(live=300, capacity=512)
    cfg["mouth"].update(live=100, capacity=256)
    cfg["camera"]["focal"] = 150.0
    return cfg, dict(TRAFFIC, frames=6)


@pytest.mark.parametrize("kind", ["face_umf", "mouth_umf", "face_pmf",
                                  "mouth_pmf"])
def test_reference_nets_match_the_program(kind):
    from instag_torch.models.motion import (MotionNetwork,
                                            MouthMotionNetwork,
                                            PersonalizedMotionNetwork)
    net = {"face_umf": lambda: MotionNetwork("deepspeech"),
           "mouth_umf": lambda: MouthMotionNetwork("deepspeech"),
           "face_pmf": lambda: PersonalizedMotionNetwork("face"),
           "mouth_pmf": lambda: PersonalizedMotionNetwork("mouth")}[kind]()
    g = gen.generator(5, "cpu")
    w = gen.net_params(reference.net_shapes(kind, "deepspeech"), g, "cpu",
                       0.05, 0.05)
    net.load_state_dict(w, strict=True)
    x = (torch.rand((200, 3), generator=g) - 0.5) * 0.3
    a = torch.randn((8, 29, 16), generator=g)
    e = torch.rand(6, generator=g)
    with torch.no_grad():
        if kind == "face_umf":
            got, ref = net(x, a, e), reference.face_umf(w, x, a, e)
        elif kind == "mouth_umf":
            mv = torch.randn((1, 3), generator=g)
            got, ref = net(x, a, mv), reference.mouth_umf(w, x, a, mv)
        elif kind == "face_pmf":
            got, ref = net(x, a, e), reference.pmf(w, kind, x, a, e)
        else:
            got, ref = net(x, a), reference.pmf(w, kind, x, a)
    for k, v in ref.items():
        torch.testing.assert_close(got[k], v, rtol=1e-5, atol=1e-6)


def test_reference_frame_matches_the_program_frame():
    cfg, tr = _tiny()
    data = clip.inputs(cfg, tr, 2 ** 31 + 9, 0, torch.device("cpu"))
    model, batch, fn = clip.program_objects(cfg, tr, data, "cpu")
    ivec = [3, 4, 5, 0]             # one chunk, DISPATCH_CHUNK frames
    got = fn(model, batch, ivec).numpy()
    t = data["track"]
    for row, i in enumerate(ivec):
        ref, counts = reference.frame(
            data["model"], clip.frame_camera(t, i), t["aud"][i], t["au"][i],
            t["torso"], 64, cfg["max_per_tile"], clip.sh_degrees(cfg))
        assert clip.compare(got[row], ref.numpy())["diff_share"] == 0.0
        assert counts["face"]["busy"] > 0 and counts["face"]["pairs"] > 0


def test_reference_steps_match_the_program_steps():
    """Three steps of train_face from iteration 1 against the reference,
    on the same seeded inputs."""
    from benchmark.drivers import adapt
    cfg = json.loads(json.dumps(CFG))
    cfg.update(image_size=64, init_num=100, capacity=1024)
    cfg["camera"]["focal"] = 150.0
    tr = json.load(open(os.path.join(HERE, "traffic",
                                     "adapt-jobs-start.json")))
    tr.update(frames=8)
    cell = dict(config=cfg, traffic=tr, clients=1)
    c = adapt.Client(cell, 11, 0, torch.device("cpu"))
    c.warm()
    c.run(0.0, 0.0)
    rec = dict(losses=[float(x) for x in c.record["losses"]],
               frames=c.record["frames"],
               grads={k: float(v) for k, v in c.record["grads"].items()},
               changes={k: float(v) for k, v in c.record["changes"].items()})
    ref = adapt._reference(cfg, tr, 11, 0, torch.device("cpu"), False)
    assert rec["frames"] == ref["frames"]
    g = reference_train.gaps(rec, ref)
    assert g["loss_gap"] < 1e-5 and g["grad_gap"] < 1e-4 \
        and g["change_gap"] < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["few-ds.clip-streams", "few-ds.adapt-jobs"])
def test_control_reads_above_the_limit_on_the_card(card, cell):
    """The reference in TF32 in the program's place, at the cell's own
    size, comes out not correct by the run's verdict."""
    from benchmark import control
    got = control.control(cell, 2 ** 31 + 101)
    assert got["correct"] is False
