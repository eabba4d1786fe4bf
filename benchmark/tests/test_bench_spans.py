"""The span table (``benchmark/spans.py``) on hand-built summaries: device
operations given to spans through correlation ids and, for backward work,
through autograd's ``sequence_nr``; blocking calls and their waits;
``_outside_program_``; the idle gaps named by span; the accepted readers
and ``breakdown`` unchanged by the new fields, and what the program's
spans change in ``breakdown``; the recorder on a CPU profile; and the
tool's run of a tiny cell on the CPU."""

import copy

import numpy as np
import pytest

from conftest import ROOT  # noqa: F401

from benchmark import spans, spec, trace
from benchmark.spans import BLOCK, LAUNCH, OUTSIDE

UNITS = ("synth.frame", "train.step")
DEV_NAMES = ["composite_fwd_kernel", "composite_bwd_kernel",
             "indexing_backward_kernel_stride_1",
             "DeviceRadixSortOnesweepKernel", "scatter_add_kernel",
             "Memcpy DtoH (Device -> Pageable)",
             "Memcpy HtoD (Pageable -> Device)", "radixSortKVInPlace",
             "elementwise_kernel"]
K = {n: i for i, n in enumerate(DEV_NAMES)}


def _summary(marks, calls, dev, nodes=(), fwd=(), span=(0, 10_000),
             host=()):
    """A client's summary: ``trace.Recorder``'s fields and the span
    fields. ``marks`` (name, start, end, thread); ``calls`` (start, end,
    thread, correlation, kind); ``dev`` (operation, start, end,
    correlation)."""
    names = list(DEV_NAMES)
    mark_names = sorted({m[0] for m in marks})
    a = lambda x, k: np.asarray(x, np.int64).reshape(-1, k)
    return dict(
        names=names, dev=a([(K[d[0]], d[1], d[2]) for d in dev], 3),
        host=a(host, 3), launches=sum(1 for c in calls if c[4] & LAUNCH),
        span=list(span), mark_names=mark_names,
        marks=a([(mark_names.index(m[0]),) + tuple(m[1:]) for m in marks],
                4),
        dev_corr=np.asarray([d[3] for d in dev], np.int64),
        calls=a(calls, 5), nodes=a(nodes, 5), fwd=a(fwd, 3))


def _step():
    """One adaptation step on thread 1, its backward on thread 2."""
    marks = [("train.step", 0, 1000, 1), ("train.forward", 10, 400, 1),
             ("hashgrid.encode", 20, 100, 1), ("train.backward", 400, 800, 1),
             ("composite.bwd", 500, 550, 2), ("optim.gaussians", 800, 900, 1)]
    # the forward operations that made nodes 7 (in hashgrid.encode) and 8
    fwd = [(30, 1, 7), (200, 1, 8)]
    nodes = [(560, 700, 2, 7, 1), (420, 480, 2, 8, 1), (710, 750, 2, -1, 0)]
    calls = [(40, 45, 1, 101, LAUNCH),        # in hashgrid.encode
             (510, 515, 2, 102, LAUNCH),      # in composite.bwd, thread 2
             (570, 575, 2, 103, LAUNCH),      # node 7: the accumulate
             (600, 605, 2, 104, LAUNCH),      # node 7: its radix sort
             (430, 435, 2, 105, LAUNCH),      # node 8, made in train.forward
             (720, 725, 2, 106, LAUNCH),      # a node without a forward op
             (850, 880, 1, 107, BLOCK),       # a copy to pageable memory
             (880, 890, 1, 108, BLOCK),       # its stream synchronisation
             (950, 960, 3, 110, LAUNCH),      # a thread without spans
             (1100, 1110, 1, 109, LAUNCH)]    # after the step
    dev = [("composite_fwd_kernel", 2000, 2100, 101),
           ("composite_bwd_kernel", 2100, 2300, 102),
           ("indexing_backward_kernel_stride_1", 2300, 2600, 103),
           ("DeviceRadixSortOnesweepKernel", 2600, 2700, 104),
           ("elementwise_kernel", 2700, 2750, 105),
           ("elementwise_kernel", 2750, 2760, 106),
           ("Memcpy DtoH (Device -> Pageable)", 2800, 2900, 107),
           ("elementwise_kernel", 3000, 3100, 109),
           ("elementwise_kernel", 3100, 3150, 110),
           ("scatter_add_kernel", 3200, 3210, 999)]   # no call traced
    return _summary(marks, calls, dev, nodes, fwd)


def test_device_ops_follow_correlation_ids_and_sequence_numbers():
    t = spans.attribute([_step()], UNITS)
    sp = t["spans"]
    ms = lambda k: round(sp[k]["device_ms"] * 1e6)       # back to ns
    assert t["units"] == 1
    assert ms("hashgrid.encode") == 100
    assert ms("composite.bwd") == 200            # its own span, thread 2
    assert ms("hashgrid.encode.bwd") == 400      # accumulate and radix sort
    assert ms("train.forward.bwd") == 50
    assert ms("train.backward") == 10            # the unit thread's span
    assert ms("optim.gaussians") == 100
    assert ms("train.step") == 50                # a thread without spans
    assert ms(OUTSIDE) == 110                    # after the step; no call
    assert round(sp["train.forward.bwd"]["device_incl_ms"] * 1e6) == 450
    # everything but the backward's work found through autograd, and the
    # work outside: 100 + 200 + 10 + 100 + 50
    assert round(sp["train.step"]["device_incl_ms"] * 1e6) == 460
    # the backward's span sits in the span open on the unit thread
    assert round(sp["train.backward"]["device_incl_ms"] * 1e6) == 210
    split = spans.share_under(t, r"indexing_backward|RadixSortOnesweep")
    assert {k: round(v * 1e6) for k, v in split.items()} == {
        "hashgrid.encode.bwd": 400}
    assert t["outside_share"] == pytest.approx(110 / 1020)
    launches = {k: v["launches"] for k, v in sp.items() if v["launches"]}
    assert launches == {"hashgrid.encode": 1, "composite.bwd": 1,
                        "hashgrid.encode.bwd": 2, "train.forward.bwd": 1,
                        "train.backward": 1, "train.step": 1, OUTSIDE: 1}


def test_blocking_calls_and_their_waits():
    t = spans.attribute([_step()], UNITS)
    row = t["spans"]["optim.gaussians"]
    assert row["blocking"] == 2
    assert round(row["wait_ms"] * 1e6) == 40
    assert sum(v["blocking"] for v in t["spans"].values()) == 2
    c, = t["clients"]
    # the step's 1000 ns on its thread less the 40 ns it waited
    assert c["units"] == 1 and round(c["dispatch_ms"] * 1e6) == 960
    assert c["blocking"] == 2
    r = spans.readings(t)
    assert r["syncs_per_step.adapt"] == 2
    assert round(r["dispatch_ms.adapt"] * 1e6) == 960
    assert round(r["hashgrid_bwd_ms.adapt"] * 1e6) == 400
    assert round(r["optim_ms.adapt"] * 1e6) == 100
    sp = t["spans"]
    assert round(sp["train.step"]["host_ms"] * 1e6) == 1000
    # less train.forward, train.backward and optim.gaussians
    assert round(sp["train.step"]["self_ms"] * 1e6) == 1000 - 390 - 400 - 100
    # less composite.bwd, on autograd's thread
    assert round(sp["train.backward"]["self_ms"] * 1e6) == 400 - 50


def test_outside_program_without_spans():
    """A program without spans (one older than ``utils/spans.py``): every
    device operation is outside, and nothing raises."""
    s = _summary([], [(10, 20, 1, 5, LAUNCH | 0), (30, 60, 1, 6, BLOCK)],
                 [("elementwise_kernel", 100, 200, 5)])
    t = spans.attribute([s], UNITS)
    assert t["units"] == 0 and t["spans"] == {}
    assert t["outside_share"] == 1.0
    assert spans.readings(t) == {}
    assert {k for k, _ in spans.idle_gaps_by_span([s], UNITS)} == {
        OUTSIDE, "_after_last_operation_"}


def test_idle_gaps_named_by_the_next_client_to_launch():
    a = _summary([("synth.frame", 0, 500, 1), ("render.face", 200, 290, 1)],
                 [(5, 6, 1, 1, LAUNCH), (210, 211, 1, 2, LAUNCH)],
                 [("elementwise_kernel", 0, 100, 1),
                  ("elementwise_kernel", 300, 400, 2)], span=(0, 500))
    b = _summary([("synth.frame", 0, 500, 7), ("render.mouth", 110, 140, 7)],
                 [(120, 121, 7, 3, LAUNCH)],
                 [("elementwise_kernel", 150, 200, 3)], span=(0, 500))
    gaps = dict(spans.idle_gaps_by_span([a, b], UNITS))
    # 100-150: b launches next, in render.mouth at 125; 200-300: a, in
    # render.face at 250; 400-500: no operation follows
    assert {k: round(v * 1e9) for k, v in gaps.items()} == {
        "render.mouth": 50, "render.face": 100, "_after_last_operation_": 100}
    merged = spans.merge(copy.deepcopy([a, b]), UNITS)
    assert merged["idle_gaps_by_span"] == spans.idle_gaps_by_span([a, b],
                                                                  UNITS)
    assert merged["spans"]["units"] == 2


def _accepted_ctx(summaries, cell, trace_units):
    merged = trace.merge(copy.deepcopy(summaries))
    c = dict(valid=900.0, busy=40.0, tiles=1024.0, pairs=30000.0)
    return dict(cell=cell, merged=merged,
                done=[dict(trace_units=trace_units)] * len(summaries),
                counts=dict(face=c, mouth=c), nvml_util=None)


def _accepted_summaries():
    full = [_step(), _step()]
    full[1]["span"] = [100, 9000]
    for s in full:
        s["host"] = np.asarray([(K["elementwise_kernel"], 0, 50),
                                (K["radixSortKVInPlace"], 60, 2500)],
                               np.int64)
        s["dev"][4, 0] = K["radixSortKVInPlace"]
        s["dev"][7, 0] = K["Memcpy HtoD (Pageable -> Device)"]
    return full


def _read_all(cell, a, b) -> None:
    """The cell's accepted readers read the same, a number, on both."""
    for m in cell["per_layer"]:
        r = spec.reader(m["name"])
        v1, v2 = r.read(a), r.read(b)
        assert v1 == v2 and v1 is not None, m["name"]


@pytest.mark.parametrize("workload", ["few-ds.clip-streams",
                                      "few-ds.adapt-jobs"])
def test_new_summary_fields_leave_accepted_readers_and_breakdown(workload):
    """The fields ``SpanRecorder`` adds to a summary change nothing that
    ``trace.merge`` and the 12 accepted readers compute."""
    cell = spec.cell(workload)
    full = _accepted_summaries()
    base_keys = ("names", "dev", "host", "launches", "span")
    bare = [{k: s[k] for k in base_keys} for s in full]
    with_fields = _accepted_ctx(full, cell, 3)
    without = _accepted_ctx(bare, cell, 3)
    assert with_fields["merged"]["breakdown"] == \
        without["merged"]["breakdown"]
    _read_all(cell, with_fields, without)


@pytest.mark.parametrize("workload", ["few-ds.clip-streams",
                                      "few-ds.adapt-jobs"])
def test_program_spans_among_host_events_rename_idle_gaps(workload):
    """The program's spans are host events (user annotations) that
    ``trace.Recorder`` keeps in ``host``: ``breakdown.idle_gaps`` then
    names a gap by the innermost span open at its midpoint, where a
    program without spans reads ``_host_between_operations_``. The device
    operations and the 12 accepted readers read as before."""
    cell = spec.cell(workload)
    bare = _accepted_summaries()
    spanned = copy.deepcopy(bare)
    for s in spanned:
        # the span around the gap 2900-3000 (midpoint 2950) that the host
        # events of ``_accepted_summaries`` leave uncovered
        s["names"] = s["names"] + ["rasterize.select"]
        s["host"] = np.vstack([s["host"], [(len(s["names"]) - 1, 2900,
                                            3050)]])
    without, with_spans = (_accepted_ctx(x, cell, 3) for x in (bare, spanned))
    b0, b1 = (c["merged"]["breakdown"] for c in (without, with_spans))
    assert b1["device_ops"] == b0["device_ops"]
    gaps0, gaps1 = dict(b0["idle_gaps"]), dict(b1["idle_gaps"])
    assert "rasterize.select" not in gaps0 and gaps1["rasterize.select"] > 0
    assert gaps1["_host_between_operations_"] == pytest.approx(
        gaps0["_host_between_operations_"] - gaps1["rasterize.select"])
    _read_all(cell, with_spans, without)


def test_named_kernels_are_the_accepted_readers_own():
    """The kernels by span that the tool reports for a metric that reads
    kernels by name sum to what that metric reads."""
    summaries = [_step(), _step()]
    t = spans.attribute(summaries, UNITS)
    assert t["units"] == 2
    for name, pattern in spans.NAMED_KERNELS.items():
        cell = spec.cell(next(w for w in ("few-ds.clip-streams",
                                          "few-ds.adapt-jobs")
                              if name in [m["name"] for m in
                                          spec.cell(w)["per_layer"]]))
        ctx = _accepted_ctx(summaries, cell, 1)
        by_span = spans.share_under(t, pattern)
        assert sum(by_span.values()) == pytest.approx(
            spec.reader(name).read(ctx)), name
    assert spans.NAMED_KERNELS["select_ms.clip"] == \
        spec.reader("select_ms.clip").PATTERN


def test_tool_runs_a_tiny_cell_through_the_harness_clients(tmp_path):
    """``spans.run_cell`` on the CPU: ``run.Clients`` spawns the clients,
    each recording through ``SpanRecorder``; every traced frame is a
    ``synth.frame`` unit in the table."""
    pytest.importorskip("torch")
    import json
    import os

    from conftest import tiny_tree
    root, here = tiny_tree(tmp_path, clients=1)
    path = os.path.join(here, "traffic", "tiny-clip.json")
    traffic = json.load(open(path))
    traffic.update(trace_lead_s=0.5, trace_s=1.0)
    json.dump(traffic, open(path, "w"))
    res = spans.run_cell("tiny.clip", 2 ** 31 + 77, 6.0, device="cpu",
                         root=root, here=here)
    frames = sum(res["traced_units"])
    assert frames > 0
    assert {c["units"] for c in res["clients"]} == {frames}
    assert res["spans"]["synth.frame"]["host_ms"] > 0
    assert {"render.face", "render.mouth", "motion.umf",
            "rasterize.select"} <= set(res["spans"])
    assert res["readings"]["dispatch_ms.clip"] > 0


def test_recorder_keeps_the_span_fields_on_a_cpu_profile():
    torch = pytest.importorskip("torch")
    from instag_torch.utils.spans import span

    rec = spans.SpanRecorder(None)
    rec.prof = rec._profile()
    rec.span = [0, 1]
    table = torch.randn(64, 2, requires_grad=True)
    idx = torch.arange(32) % 7
    with span("train.step"):
        with span("train.forward"):
            with span("hashgrid.encode"):
                y = table[idx]
            loss = (y * y).sum()
        with span("train.backward"):
            loss.backward()
    rec.prof.stop()
    s = rec.summary()
    assert set(s["mark_names"]) == {"train.step", "train.forward",
                                    "hashgrid.encode", "train.backward"}
    assert len(s["marks"]) == 4 and len(s["dev_corr"]) == len(s["dev"])
    # the gather's node, and the forward operation that made it
    assert len(s["nodes"]) and set(s["nodes"][:, 3]) & set(s["fwd"][:, 2])
    t = spans.attribute([s], UNITS)
    assert t["units"] == 1
    assert set(t["spans"]) == set(s["mark_names"])
    assert spans.merge([s], UNITS)["spans"]["units"] == 1
