"""``BENCHMARK.json`` and the files it names: a cell's configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``),
limits of ``correct`` (``limits/<cell>.json``), the driver of its kind of
window (``drivers/<kind>.py``) and the readers of its per-layer metrics
(``metrics/<metric>.py``). Everything is found by name, so a later change
adds a cell, a mix or a metric by adding files and entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load(os.path.join(root, "BENCHMARK.json"))


def reader(name: str, here: str = HERE):
    """The module ``metrics/<name>.py`` (its ``read(ctx)``)."""
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: str = ROOT, here: str = HERE) -> dict:
    """Everything one cell needs, resolved by name."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load(os.path.join(root, conf["file"]))
    traffic = _load(os.path.join(here, "traffic", f"{w['traffic']}.json"))
    lim_path = os.path.join(here, "limits", f"{name}.json")
    limits = _load(lim_path) if os.path.exists(lim_path) else {}

    def applies(m):
        return m.get("workloads") is None or name in m["workloads"]
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if applies(m) and m["moves"] in reported]
    return dict(name=name, workload=w, config=config, traffic=traffic,
                limits=limits, end_to_end=e2e, per_layer=layer,
                clients=int(traffic["clients"]), kind=traffic["driver"],
                chips=int(w["chips"]))


def driver(kind: str):
    """The module ``drivers/<kind>.py``."""
    return importlib.import_module(f"{__package__}.drivers.{kind}")
