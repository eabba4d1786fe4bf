"""The port's named spans (``instag_torch/utils/spans.py``) under a CPU
``torch.profiler``: one synthesis frame and one face adaptation step each
emit every span of their path, nested as the layers are, inside one unit
span, and no span outside the registry; their outputs are bitwise the same
with the profiler on and off; without a profiler ``span`` is the shared
no-op."""

import contextlib

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from instag_torch.bench_utils import (synthetic_camera, synthetic_frame_batch,
                                      synthetic_motion_params,
                                      synthetic_state)
from instag_torch.config import OptimizationConfig
from instag_torch.models import gaussians as G
from instag_torch.ops.rasterize import RasterizeConfig
from instag_torch.synthesize import SynthesisModel, make_synthesis_fn
from instag_torch.train.face import Flags, make_face_step
from instag_torch.utils import spans
from tests.torch_cpu import one_torch_thread  # noqa: F401

SIZE, K = 64, 64
CFG = RasterizeConfig(SIZE, SIZE, max_per_tile=K)
BRANCH = ("render.face", "render.mouth")
NETS = ("motion.umf", "motion.pmf")
RENDER = {"rasterize.project": BRANCH, "rasterize.select": BRANCH,
          "render.sh": BRANCH, "composite.fwd": BRANCH}
# each span of a path and the spans that may directly enclose it
SYNTH = dict(RENDER, **{
    "synth.frame": (None,), "render.face": ("synth.frame",),
    "render.mouth": ("synth.frame",), "render.fuse": ("synth.frame",),
    "motion.umf": BRANCH, "motion.pmf": BRANCH, "hashgrid.encode": NETS,
    "render.move_feature": ("render.mouth",)})
STEP = dict({k: ("train.forward",) for k in RENDER}, **{
    "train.step": (None,), "train.forward": ("train.step",),
    "train.backward": ("train.step",), "optim.gaussians": ("train.step",),
    "optim.nets": ("train.step",), "motion.umf": ("train.forward",),
    "motion.pmf": ("train.forward",), "hashgrid.encode": NETS,
    # the CPU runs the backward on the calling thread
    "composite.bwd": ("train.backward",),
    "scatter.add": ("train.backward",)})


def _frame():
    """One 64 px synthesis frame, everything made anew from fixed seeds."""
    nets = synthetic_motion_params(seed=3, device="cpu")
    model = SynthesisModel(
        synthetic_state(300, 512, seed=1, max_sh_degree=1, device="cpu"),
        synthetic_state(100, 256, seed=2, max_sh_degree=2, device="cpu"),
        nets["face_umf"], nets["mouth_umf"], nets["face_pmf"],
        nets["mouth_pmf"])
    fn = make_synthesis_fn(CFG, dilate=True, device="cpu")
    torso = torch.full((3, SIZE, SIZE), 0.5)
    return lambda: fn(model, synthetic_camera(SIZE, device="cpu"),
                      nets["aud"], nets["exp"], torso)


def _step():
    """One face adaptation step at iteration 1, made anew likewise."""
    nets = synthetic_motion_params(seed=3, device="cpu")
    state = synthetic_state(300, 512, seed=1, device="cpu")
    step = make_face_step(CFG, OptimizationConfig(), nets["face_umf"].train(),
                          nets["face_pmf"].train(), 1.0, False, device="cpu")
    batch = synthetic_frame_batch(SIZE, 2, device="cpu")
    flags = Flags(align=1.0, use_regs=1.0, use_sapiens=0.0, use_depth=0.0,
                  hair_paint=0.0, use_lpips=0.0)

    def run():
        st, gopt, loss = step(state, G.adam_init(state.params), batch, 0, 1,
                              flags)
        return [loss] + [getattr(st.params, n) for n in G.PARAM_FIELDS] + [
            p for net in (step.umf_net, step.pmf_net)
            for p in net.parameters()]
    return run


def _traced(run):
    """The outputs of ``run()`` and the user annotations it recorded:
    (name, start, end, thread)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    marks = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
             for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and e.device_type() == DeviceType.CPU]
    return out, marks


def _parent(marks, i):
    """The innermost span that encloses span ``i`` on its thread."""
    name, s, e, tid = marks[i]
    best = None
    for j, (_, s2, e2, t2) in enumerate(marks):
        if j != i and t2 == tid and s2 <= s and e <= e2 and (
                best is None or s2 >= marks[best][1]):
            best = j
    return None if best is None else marks[best][0]


def _check_nesting(marks, path: dict, unit: str):
    # PyTorch's own optimizers annotate their steps; every other span is
    # the program's, and the program's come from the registry
    ours = [m for m in marks if not m[0].startswith("Optimizer.")]
    assert {m[0] for m in ours} <= set(spans.NAMES)
    assert {m[0] for m in ours} == set(path)
    assert [m[0] for m in ours].count(unit) == 1
    for i, m in enumerate(ours):
        assert _parent(ours, i) in path[m[0]], m[0]
    (_, u0, u1, _), = [m for m in ours if m[0] == unit]
    assert all(u0 <= m[1] and m[2] <= u1 for m in ours)


@pytest.mark.parametrize("make, path, unit", [
    (_frame, SYNTH, "synth.frame"), (_step, STEP, "train.step")],
    ids=["synthesis_frame", "face_step"])
def test_spans_of_a_path(make, path, unit):
    plain = make()()
    traced, marks = _traced(make())
    _check_nesting(marks, path, unit)
    if isinstance(plain, torch.Tensor):
        plain, traced = [plain], [traced]
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_span_off_is_the_shared_no_op():
    off = spans.span("render.face")
    assert isinstance(off, contextlib.nullcontext)
    assert off is spans.span("train.step")
    with off, off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.span("render.face") is not off
    with pytest.raises(ValueError):
        spans.span("render.elsewhere")
    with pytest.raises(ValueError):
        spans.spanned("render.elsewhere")
