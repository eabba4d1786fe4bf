"""The harness: every cell resolves to its files, files added later are
taken without editing one, BENCHMARK.json keeps the contract's shape, a run
drives the program on the CPU at a tiny size and judges it, and a broken
timed path comes out not correct."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import HERE, ROOT, tiny_tree

from benchmark import run, spec, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_every_workload_resolves_to_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        drv = spec.driver(cell["kind"])
        assert drv.RATE_METRIC in {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in {m["name"] for m in cell["end_to_end"]}
        assert cell["limits"], f"{w['name']} has no limits file"
        assert cell["per_layer"], f"{w['name']} reports no per-layer metric"
        for m in cell["per_layer"]:
            reader = spec.reader(m["name"])
            assert reader.LAYER == m["layer"]
            assert callable(reader.read)


def test_benchmark_json_keeps_the_contract_shape():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"][:2] == ["python3", "benchmark/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert c["file"].startswith("benchmark/")
        f = json.load(open(os.path.join(ROOT, c["file"])))
        assert f["reduced"] == c["reduced"] and f["source"] == c["source"]
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


def _digest(root):
    h = hashlib.sha256()
    for d, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            with open(os.path.join(d, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()


def test_added_config_traffic_and_metric_are_taken_without_edits(tmp_path):
    """A later change adds a configuration, a traffic mix and a per-layer
    metric as new files and entries: the new cell resolves, and no file
    that was there changes."""
    root = tmp_path
    shutil.copytree(HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digest(root / "benchmark")
    here = str(root / "benchmark")
    cfg = json.load(open(os.path.join(HERE, "configs", "instag-few-ds.json")))
    cfg.update(name="extra", reduced=["N_views"], N_views=100)
    json.dump(cfg, open(os.path.join(here, "configs", "extra.json"), "w"))
    tr = json.load(open(os.path.join(HERE, "traffic", "clip-streams.json")))
    tr.update(clients=2, why="two streams")
    json.dump(tr, open(os.path.join(here, "traffic", "two-streams.json"), "w"))
    with open(os.path.join(here, "metrics", "frames_seen.clip.py"), "w") as f:
        f.write('LAYER = "host dispatch: synthesize.py -> render.py"\n\n\n'
                'def read(ctx):\n    return 1.0\n')
    shutil.copy(os.path.join(here, "limits", "few-ds.clip-streams.json"),
                os.path.join(here, "limits", "extra.two-streams.json"))
    after_add = {p for p in (root / "benchmark").rglob("*") if p.is_file()}
    b = json.load(open(root / "BENCHMARK.json"))
    b["configs"].append(dict(name="extra", source=cfg["source"],
                             file="benchmark/configs/extra.json",
                             reduced=["N_views"], why="a shorter track"))
    b["workloads"].append(dict(name="extra.two-streams", config="extra",
                               traffic="two-streams", chips=1, why="test"))
    for m in b["end_to_end"]:
        if m.get("workloads") and "few-ds.clip-streams" in m["workloads"]:
            m["workloads"].append("extra.two-streams")
    b["per_layer"].append(dict(
        name="frames_seen.clip", unit="frames", better="higher",
        source="program_counter", layer="host dispatch: synthesize.py -> "
        "render.py", moves="clip_fps", workloads=["extra.two-streams"]))
    json.dump(b, open(root / "BENCHMARK.json", "w"))
    cell = spec.cell("extra.two-streams", str(root), here)
    assert cell["config"]["N_views"] == 100 and cell["clients"] == 2
    assert "frames_seen.clip" in [m["name"] for m in cell["per_layer"]]
    assert spec.reader("frames_seen.clip", here).read({}) == 1.0
    for p in after_add:
        rel = p.relative_to(root / "benchmark")
        if rel.parts[0] in ("configs", "traffic", "metrics", "limits") \
                and rel.name.startswith(("extra", "two-streams",
                                         "frames_seen")):
            p.unlink()
    assert _digest(root / "benchmark") == before


def _run(root, here, cell, seconds=3.0, **kw):
    return run.run_cell(cell, 2 ** 31 + 4321, seconds, False, device="cpu",
                        spawn=False, root=root, here=here,
                        t_start=time.monotonic(), **kw)


def test_tiny_clip_run_is_correct_and_prints_no_device_metric(tmp_path):
    root, here = tiny_tree(tmp_path)
    res = _run(root, here, "tiny.clip")
    assert res["correct"] and res["attempted"] > 0
    assert "metrics" not in res and "device" not in res
    assert list(res)[-1] == "checks"


def test_tiny_adapt_run_is_correct(tmp_path):
    root, here = tiny_tree(tmp_path)
    res = _run(root, here, "tiny.adapt")
    assert res["correct"] and res["attempted"] > 0
    assert "metrics" not in res


def test_clip_frame_altered_where_produced_is_not_correct(tmp_path,
                                                         monkeypatch):
    """Each stream's chunk renders the next frame's inputs in place of its
    own (an answer altered where it is produced)."""
    import instag_torch.synthesize as syn
    make = syn.make_synthesis_chunk_fn

    def broken(*a, **kw):
        fn = make(*a, **kw)
        return lambda model, batch, ivec: fn(
            model, batch, [(i + 1) % batch.num_frames for i in ivec])
    monkeypatch.setattr(syn, "make_synthesis_chunk_fn", broken)
    root, here = tiny_tree(tmp_path)
    res = _run(root, here, "tiny.clip")
    assert not res["correct"]


def test_adapt_step_returning_its_state_unchanged_is_not_correct(
        tmp_path, monkeypatch):
    import instag_torch.train.face as face
    step = face.adaptation_step

    def unchanged(st, state, gopt, *a):
        _, gopt2, loss = step(st, state, gopt, *a)
        return state, gopt2, loss
    monkeypatch.setattr(face, "adaptation_step", unchanged)
    root, here = tiny_tree(tmp_path)
    res = _run(root, here, "tiny.adapt")
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] > 0.5


def test_adapt_frame_altered_where_produced_is_not_correct(tmp_path,
                                                          monkeypatch):
    """The step renders and scores the next frame in place of the drawn
    one."""
    import instag_torch.train.face as face
    loss = face._FaceStep.loss

    def shifted(self, state, off, batch, i, *a):
        return loss(self, state, off, batch, (i + 1) % batch.num_frames, *a)
    monkeypatch.setattr(face._FaceStep, "loss", shifted)
    root, here = tiny_tree(tmp_path)
    res = _run(root, here, "tiny.adapt")
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["tiny.clip", "tiny.adapt"])
def test_tf32_control_comes_out_not_correct(tmp_path, cell):
    """The control, the reference in TF32 in the program's place, goes
    through the run's verdict against the cell's limits and fails it."""
    from benchmark import control
    root, here = tiny_tree(tmp_path)
    got = control.control(cell, 2 ** 31 + 77, device="cpu", root=root,
                          here=here)
    assert got["correct"] is False
    assert any(c["value"] > c["limit"] for c in got["checks"].values())


def test_adapt_jobs_start_again_before_densification():
    """A job that reaches last_iteration ends there and the next starts
    from iteration 1 with the same weights; its first steps, which
    ``correct`` judges, are the first job's."""
    import torch

    from benchmark import reference_train
    from benchmark.drivers import adapt
    cfg = json.load(open(os.path.join(HERE, "configs", "instag-few-ds.json")))
    cfg.update(image_size=64, init_num=100, capacity=1024)
    cfg["camera"]["focal"] = 150.0
    tr = json.load(open(os.path.join(HERE, "traffic",
                                     "adapt-jobs-start.json")))
    tr.update(frames=8, last_iteration=7)
    cell = dict(config=cfg, traffic=tr, clients=1)
    seen = []
    c = adapt.Client(cell, 13, 0, torch.device("cpu"))
    probe = c.probe

    def watch(inner):
        step = probe(inner)

        def wrapped(state, gopt, batch, i, it, *a):
            seen.append(it)
            return step(state, gopt, batch, i, it, *a)
        return wrapped
    c.probe = watch
    c.warm()
    t0 = time.monotonic()
    out = c.run(t0, t0 + 4.0)
    assert out["jobs"] >= 2 and max(seen) == tr["last_iteration"] + 1
    assert seen[:8] == list(range(1, 9)) and seen[8] == 1
    rec = dict(losses=[float(x) for x in c.record["losses"]],
               frames=c.record["frames"],
               grads={k: float(v) for k, v in c.record["grads"].items()},
               changes={k: float(v) for k, v in c.record["changes"].items()})
    ref = adapt._reference(cfg, tr, 13, 0, torch.device("cpu"), False)
    assert rec["frames"] == ref["frames"]
    assert reference_train.gaps(rec, ref)["change_gap"] < 1e-4
    tr.update(last_iteration=501)
    with pytest.raises(ValueError):
        adapt.Client(cell, 13, 0, torch.device("cpu"))


def test_traced_spans_overlap_however_late_a_client_starts(tmp_path):
    """No client stops tracing before every client has started and
    trace_s has passed since the last start."""
    a = trace.SpanBarrier(str(tmp_path), 0, 2)
    b = trace.SpanBarrier(str(tmp_path), 1, 2)
    a.mark()
    assert not a.may_stop(0.0)          # b has not started
    time.sleep(0.05)
    b.mark()
    assert a.may_stop(0.0) and b.may_stop(0.0)
    assert not trace.SpanBarrier(str(tmp_path), 0, 2).may_stop(60.0)


def test_trace_merge_takes_the_union_of_the_clients():
    names = ["k", "aten::mm"]
    a = dict(names=names, dev=np.array([[0, 0, 10], [0, 20, 30]]),
             host=np.array([[1, 5, 25]]), launches=2, span=[0, 40])
    b = dict(names=names, dev=np.array([[0, 5, 15]]),
             host=np.zeros((0, 3), np.int64), launches=1, span=[0, 40])
    m = trace.merge([a, b])
    assert m["busy_s"] == pytest.approx(25e-9)
    assert m["window_s"] == pytest.approx(40e-9)
    assert m["launches"] == 3
    gaps = dict(m["breakdown"]["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(5e-9)          # 15..20
    assert gaps["_after_last_operation_"] == pytest.approx(10e-9)


def test_run_without_a_card_exits_nonzero_and_prints_nothing(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    rc = run.main(["--workload", "few-ds.clip-streams", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_run_in_a_tree_of_only_the_benchmark_exits_nonzero(tmp_path):
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "few-ds.clip-streams", "--seed", "1", "--seconds",
                        "1"], cwd=tmp_path, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0 and p.stdout == ""
