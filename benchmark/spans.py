"""The program's named spans in a traced run (``instag_torch/utils/spans.py``
names them), read from the same ``torch.profiler`` trace as ``trace.py``:
each device operation, kernel launch and blocking runtime call given to
the layer that made it, per unit (a synthesis frame, an adaptation step)
over every client; and the card's idle gaps named by the span that the
next client to launch was in.

A runtime call (and each device operation, through its correlation id to
the call that launched it) goes to:
  1. the innermost program span open on the call's thread at its start;
  2. else, where the call runs inside an autograd node, the innermost span
     of the forward operation that made the node (the node's
     ``sequence_nr`` on its ``fwd_thread_id``), with ``.bwd`` added: so
     ``hashgrid.encode.bwd`` holds ``index_put_``'s accumulate and its
     radix sort;
  3. else the innermost span open on the client's unit thread then;
  4. else ``_outside_program_``.

Blocking calls are the runtime's synchronisations (stream, device,
event), ``cudaMemcpy``, and a ``cudaMemcpyAsync`` whose device operation
copies to pageable memory; the host waits inside them.

Run one cell traced, on a machine with a card, and print the table:

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds 20

Its clients are ``run.py``'s (``run.Clients``, ``worker.main``), recording
through ``SpanRecorder`` (``trace.Recorder`` with the fields above);
``run.py``'s own traced run keeps only ``trace.Recorder``'s.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import re
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import trace  # noqa: E402

OUTSIDE = "_outside_program_"
BLOCKING = re.compile(r"^(cudaStreamSynchronize|cudaDeviceSynchronize"
                      r"|cudaEventSynchronize|cudaMemcpy)$")
NODE = "autograd::engine::evaluate_function"
LAUNCH, BLOCK = 1, 2
TOP = trace.TOP


def registry():
    """The program's span names and unit spans; none where the program
    has no spans."""
    try:
        from instag_torch.utils.spans import NAMES, UNITS
    except ImportError:
        return (), ()
    return NAMES, UNITS


class SpanRecorder(trace.Recorder):
    """``trace.Recorder`` whose summary also keeps the program's spans
    (``marks``: name index into ``mark_names``, start, end, thread), each
    device operation's correlation id (``dev_corr``, row for row with
    ``dev``), the runtime calls that launch, block or start a device
    operation (``calls``: start, end, thread, correlation id, kind bits
    ``LAUNCH`` | ``BLOCK``), autograd's nodes (``nodes``: start, end,
    thread, sequence_nr, forward thread) and the forward operations that
    made nodes (``fwd``: start, thread, sequence_nr). A client of a run
    (one with a barrier) also writes these fields into the run directory,
    beside the summary that ``worker.main`` saves."""

    def summary(self) -> dict:
        from torch.autograd import DeviceType
        out = super().summary()
        names = set(registry()[0])
        mark_names: dict[str, int] = {}
        marks, dev_corr, calls, nodes, fwd = [], [], [], [], []
        dev_ops = {}
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    dev_corr.append(e.correlation_id())
                    dev_ops[e.correlation_id()] = e.name()
                continue
            name, s = e.name(), e.start_ns()
            row = (s, s + e.duration_ns(), e.start_thread_id())
            if e.is_user_annotation():
                if name in names:
                    k = mark_names.setdefault(name, len(mark_names))
                    marks.append((k,) + row)
            elif name.startswith("cu"):
                calls.append((name, row + (e.correlation_id(),)))
            elif name.startswith(NODE):
                nodes.append(row + (e.sequence_nr(), e.fwd_thread_id()))
            elif e.sequence_nr() >= 0 and e.fwd_thread_id() == 0:
                fwd.append((s, row[2], e.sequence_nr()))
        kept = []
        for name, row in calls:
            kind = (LAUNCH if trace.LAUNCH.match(name) else 0) | (
                BLOCK if BLOCKING.match(name) or (
                    name == "cudaMemcpyAsync"
                    and "Pageable" in dev_ops.get(row[3], "")
                    and "DtoH" in dev_ops[row[3]]) else 0)
            if kind or row[3] in dev_ops:
                kept.append(row + (kind,))

        def arr(x, k):
            return np.asarray(x, np.int64).reshape(-1, k)
        fields = dict(mark_names=list(mark_names), marks=arr(marks, 4),
                      dev_corr=np.asarray(dev_corr, np.int64),
                      calls=arr(kept, 5), nodes=arr(nodes, 5),
                      fwd=arr(fwd, 3))
        if self.barrier is not None:    # a client of a run: beside its trace
            b = self.barrier
            with open(_fields_path(os.path.dirname(b.path), b.index),
                      "wb") as f:
                pickle.dump(fields, f)
        return dict(out, **fields)


def _fields_path(run_dir: str, index: int) -> str:
    return os.path.join(run_dir, f"spans_{index}.pkl")


class _Line:
    """The innermost of properly nested intervals at a time, on one
    thread: ``at(t)`` gives the interval's index (into the rows it was
    built from) or -1; ``parent[i]`` is the interval directly enclosing
    interval ``i`` (or -1)."""

    def __init__(self, starts, ends, index):
        self.parent = {}
        times, owner, stack = [], [], []
        for i in sorted(range(len(index)), key=lambda i: (starts[i],
                                                          -ends[i])):
            while stack and ends[stack[-1]] <= starts[i]:
                j = stack.pop()
                times.append(ends[j])
                owner.append(index[stack[-1]] if stack else -1)
            self.parent[index[i]] = index[stack[-1]] if stack else -1
            stack.append(i)
            times.append(starts[i])
            owner.append(index[i])
        while stack:
            j = stack.pop()
            times.append(ends[j])
            owner.append(index[stack[-1]] if stack else -1)
        self.times = np.asarray(times, np.int64)
        self.owner = np.asarray(owner, np.int64)

    def at(self, t):
        k = np.searchsorted(self.times, t, side="right") - 1
        return np.where(k >= 0, self.owner[np.maximum(k, 0)], -1)


def _lines(rows, start=0, end=1, tid=2) -> dict:
    return {t: _Line(rows[idx, start], rows[idx, end], idx)
            for t, idx in _threads(rows[:, tid])}


def _at(lines: dict, tid: int, t) -> np.ndarray:
    t = np.asarray(t, np.int64)
    line = lines.get(int(tid))
    return line.at(t) if line is not None else np.full(t.shape, -1)


def _threads(tids):
    """(thread, the indices of its rows) for each thread in ``tids``."""
    for t in np.unique(tids):
        yield int(t), np.flatnonzero(tids == t)


def _find(keys, want) -> np.ndarray:
    """The index in ``keys`` (distinct) of each of ``want``, or -1."""
    if not len(keys):
        return np.full(len(want), -1, np.int64)
    order = np.argsort(keys, kind="stable")
    k = np.minimum(np.searchsorted(keys[order], want), len(keys) - 1)
    return np.where(keys[order][k] == want, order[k], -1)


def _made(fwd) -> dict:
    """Per thread, its forward operations' sequence numbers (sorted,
    unique) and the start of the latest-started operation of each: the
    one that made the node of that number."""
    out = {}
    for tid, idx in _threads(fwd[:, 1]):
        f = fwd[idx][np.lexsort((fwd[idx, 0], fwd[idx, 2]))]
        last = np.r_[f[1:, 2] != f[:-1, 2], True]
        out[tid] = (f[last, 2], f[last, 0])
    return out


class Client:
    """One client's summary, attributed: each runtime call's span
    (``call_mark``, -1 outside the program) and whether it is a
    backward's (``call_bwd``), and each device operation's call."""

    def __init__(self, s: dict, units):
        self.m, self.names = s["marks"], s["mark_names"]
        self.mname = [self.names[i] for i in self.m[:, 0]]
        self.marks = _lines(self.m, 1, 2, 3)
        is_unit = np.array([n in units for n in self.mname], bool)
        self.unit_rows = np.flatnonzero(is_unit)
        tids = self.m[self.unit_rows, 3]
        self.unit_tid = -1
        if len(tids):
            have, count = np.unique(tids, return_counts=True)
            self.unit_tid = int(have[count.argmax()])
            self.unit_rows = self.unit_rows[tids == self.unit_tid]
        self.unit_rows = self.unit_rows[np.argsort(self.m[self.unit_rows, 1])]
        # a span with none around it on its own thread (a backward's, on
        # autograd's thread) sits in the span open on the unit thread
        self.parent = {}
        for tid, line in self.marks.items():
            for i, p in line.parent.items():
                if p < 0 and tid != self.unit_tid:
                    p = int(_at(self.marks, self.unit_tid, self.m[i, 1]))
                self.parent[i] = p
        self.calls = s["calls"]
        self.call_mark, self.call_bwd = self._attribute(s)
        self.dev_call = _find(self.calls[:, 3], s["dev_corr"])

    def _attribute(self, s):
        c = self.calls
        mark = np.full(len(c), -1, np.int64)
        bwd = np.zeros(len(c), bool)
        for tid, idx in _threads(c[:, 2]):
            mark[idx] = _at(self.marks, tid, c[idx, 0])
        nodes, fwd = s["nodes"], s["fwd"]
        left = np.flatnonzero(mark < 0)
        if len(left) and len(nodes) and len(fwd):
            node_lines = _lines(nodes)
            n = np.full(len(left), -1, np.int64)
            for tid, idx in _threads(c[left, 2]):
                n[idx] = _at(node_lines, tid, c[left[idx], 0])
            left, n = left[n >= 0], n[n >= 0]
            made = _made(fwd)
            for tid, idx in _threads(nodes[n, 4]):
                if tid not in made:
                    continue
                seqs, starts = made[tid]
                k = _find(seqs, nodes[n[idx], 3])
                mk = np.where(k >= 0, _at(self.marks, tid, starts[k]), -1)
                mark[left[idx]] = mk
                bwd[left[idx]] = mk >= 0
        left = np.flatnonzero(mark < 0)
        if len(left):
            mark[left] = _at(self.marks, self.unit_tid, c[left, 0])
        return mark, bwd

    def key(self, mark: int, bwd: bool) -> str:
        if mark < 0:
            return OUTSIDE
        return self.mname[mark] + (".bwd" if bwd else "")

    def chain(self, mark: int, bwd: bool) -> list:
        """The span and every span enclosing it, as keys."""
        out = []
        while mark >= 0:
            out.append(self.key(mark, bwd))
            mark = self.parent.get(mark, -1)
        return out or [OUTSIDE]

    def unit_of(self, t) -> np.ndarray:
        """The ordinal of the unit open on the unit thread at each time,
        or -1."""
        u, t = self.m[self.unit_rows], np.asarray(t, np.int64)
        if not len(u):
            return np.full(t.shape, -1)
        k = np.searchsorted(u[:, 1], t, side="right") - 1
        return np.where((k >= 0) & (u[np.maximum(k, 0), 2] > t), k, -1)


def _row(table: dict, key: str) -> dict:
    return table.setdefault(key, dict(host_ms=0.0, self_ms=0.0, launches=0,
                                      blocking=0, wait_ms=0.0, device_ms=0.0,
                                      device_incl_ms=0.0))


def attribute(summaries: list, units=None) -> dict:
    """The span table of the clients' summaries: per span (a ``.bwd`` key
    for backward work found through autograd, ``_outside_program_`` for
    the rest), per unit and over every client, the host ms (the span's
    whole time and its self time, less its child spans), launches,
    blocking calls and the host's ms inside them, device ms of the
    operations given to it and (``device_incl_ms``) to it and the spans it
    encloses; device ms by operation name and span (``device_ops``);
    per client the units, the host ms a unit less the blocking waits in
    it (``dispatch_ms``) and the blocking calls a unit inside program
    spans (``blocking``); and the share of device time outside the
    program."""
    units = registry()[1] if units is None else units
    table: dict = {}
    ops: dict = {}
    clients = []
    n_units = 0
    dev_total = dev_out = 0.0
    for s in summaries:
        c = Client(s, units)
        n = len(c.unit_rows)
        n_units += n
        m = c.m
        dur = (m[:, 2] - m[:, 1]) / 1e6
        for i, name in enumerate(c.mname):
            _row(table, name)["host_ms"] += dur[i]
            _row(table, name)["self_ms"] += dur[i]
            p = c.parent.get(i, -1)
            if p >= 0:
                _row(table, c.mname[p])["self_ms"] -= dur[i]
        # key ids: 0 outside the program, 2 (mark + 1) + bwd for a span
        nk = 2 * (len(m) + 1)
        keys = [OUTSIDE, OUTSIDE] + [k for i in range(len(m))
                                     for k in (c.key(i, False),
                                               c.key(i, True))]
        calls = c.calls
        cid = 2 * (c.call_mark + 1) + c.call_bwd
        wait = (calls[:, 1] - calls[:, 0]) / 1e6
        blocks = (calls[:, 4] & BLOCK) > 0
        sums = dict(
            launches=np.bincount(cid, (calls[:, 4] & LAUNCH) > 0, nk),
            blocking=np.bincount(cid, blocks, nk),
            wait_ms=np.bincount(cid, wait * blocks, nk))
        dev = s["dev"]
        ms = (dev[:, 2] - dev[:, 1]) / 1e6
        did = np.where(c.dev_call >= 0, cid[np.maximum(c.dev_call, 0)], 0) \
            if len(calls) else np.zeros(len(dev), np.int64)
        sums["device_ms"] = np.bincount(did, ms, nk)
        for f, v in sums.items():
            for k in np.flatnonzero(v):
                _row(table, keys[k])[f] += v[k]
        for k in np.flatnonzero(sums["device_ms"]):
            for key in c.chain(k // 2 - 1, bool(k % 2)):
                _row(table, key)["device_incl_ms"] += sums["device_ms"][k]
        pair, inv = np.unique(dev[:, 0] * nk + did, return_inverse=True)
        for p, v in zip(pair, np.bincount(inv, ms)):
            op = (s["names"][p // nk], keys[p % nk])
            ops[op] = ops.get(op, 0.0) + v
        dev_total += float(ms.sum())
        dev_out += float(sums["device_ms"][:2].sum())
        # the unit thread's host time in units, less its blocking waits
        u = m[c.unit_rows]
        host = float((u[:, 2] - u[:, 1]).sum()) / 1e6
        on = (calls[:, 2] == c.unit_tid) & blocks
        waits = float(wait[on & (c.unit_of(calls[:, 0]) >= 0)].sum())
        inside = blocks & (c.call_mark >= 0)
        clients.append(dict(units=n,
                            dispatch_ms=(host - waits) / n if n else None,
                            blocking=int(inside.sum()) / n if n else None))
    per = {k: {f: float(v) / n_units for f, v in row.items()}
           for k, row in table.items()} if n_units else {}
    return dict(units=n_units, spans=per, clients=clients,
                device_ops={f"{op} @ {k}": v / n_units
                            for (op, k), v in ops.items()} if n_units else {},
                outside_share=dev_out / dev_total if dev_total else None)


def idle_gaps_by_span(summaries: list, units=None) -> list:
    """The card's idle gaps over the clients' common span (as
    ``trace.merge`` finds them), each named by the innermost program span
    open at its midpoint on the next client to launch: on the thread that
    launched that client's next operation, or else on its unit thread.
    The largest ``TOP`` names, in seconds."""
    units = registry()[1] if units is None else units
    lo = max(s["span"][0] for s in summaries)
    hi = min(s["span"][1] for s in summaries)
    clients = [Client(s, units) for s in summaries]
    devs = [np.column_stack([s["dev"][:, 1], np.full(len(s["dev"]), c),
                             np.arange(len(s["dev"]))])
            for c, s in enumerate(summaries) if len(s["dev"])]
    iv = [s["dev"][:, 1:] for s in summaries if len(s["dev"])]
    if not devs:
        return []
    _, gaps = trace.union_busy(np.concatenate(iv), lo, hi)
    starts = np.concatenate(devs)
    starts = starts[np.argsort(starts[:, 0], kind="stable")]
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        k = np.searchsorted(starts[:, 0], g1, side="left")
        what = "_after_last_operation_"
        if k < len(starts):
            c = clients[int(starts[k, 1])]
            i = c.dev_call[int(starts[k, 2])]
            mid = (g0 + g1) // 2
            mark = -1
            if i >= 0:
                mark = int(_at(c.marks, c.calls[i, 2], mid))
            if mark < 0:
                mark = int(_at(c.marks, c.unit_tid, mid))
            what = c.key(mark, False)
        idle[what] = idle.get(what, 0.0) + (g1 - g0) / 1e9
    return sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[
        :TOP]


def merge(summaries: list, units=None) -> dict:
    """``trace.merge`` of the summaries with the span table (``spans``)
    and ``idle_gaps_by_span`` beside its keys."""
    out = trace.merge(summaries)
    out["spans"] = attribute(summaries, units)
    out["idle_gaps_by_span"] = idle_gaps_by_span(summaries, units)
    return out


def _sum(spans: dict, keys, field: str):
    have = [spans[k][field] for k in keys if k in spans]
    return sum(have) if have else None


def readings(table: dict) -> dict:
    """The per-layer numbers of a cell's span table, per unit: the host
    dispatch (host ms inside the unit span less its blocking waits, the
    mean over clients), the blocking calls inside program spans, and the
    device ms under the layers that each cell's optimisations aim at."""
    sp, cl = table["spans"], [c for c in table["clients"] if c["units"]]
    dispatch = (sum(c["dispatch_ms"] for c in cl) / len(cl)) if cl else None
    syncs = sum(sp[k]["blocking"] for k in sp if k != OUTSIDE) if cl \
        else None
    if "synth.frame" in sp:
        return {"dispatch_ms.clip": dispatch, "syncs_per_frame.clip": syncs,
                "motion_ms.clip": _sum(sp, ("motion.umf", "motion.pmf"),
                                       "device_incl_ms"),
                "select_span_ms.clip": _sum(sp, ("rasterize.select",),
                                            "device_incl_ms")}
    if "train.step" in sp:
        return {"dispatch_ms.adapt": dispatch, "syncs_per_step.adapt": syncs,
                "hashgrid_bwd_ms.adapt": _sum(sp, ("hashgrid.encode.bwd",),
                                              "device_incl_ms"),
                "optim_ms.adapt": _sum(sp, ("optim.gaussians", "optim.nets"),
                                       "device_incl_ms")}
    return {}


def share_under(table: dict, pattern: str) -> dict:
    """Device ms a unit of the operations whose names match, by span."""
    rx, out = re.compile(pattern), {}
    for key, v in table["device_ops"].items():
        op, span = key.rsplit(" @ ", 1)
        if rx.search(op):
            out[span] = out.get(span, 0.0) + v
    return out


# ----------------------------------------------------------------- the run
# the accepted metrics that read kernels by name, and the names they read
NAMED_KERNELS = {
    "select_ms.clip": r"(?i)topk|radixsort|digitcount|digitcumsum",
    "gather_bwd_ms.adapt": r"indexing_backward_kernel"}


def _process_main(conn, *args) -> None:
    """A client of ``run.Clients`` whose ``worker.main`` records through
    ``SpanRecorder`` (it takes ``trace.Recorder`` when it runs)."""
    from benchmark import worker
    trace.Recorder = SpanRecorder
    worker.process_main(conn, *args)


def run_cell(name: str, seed: int, seconds: float, device: str = "cuda",
             root: str = ROOT, here: str = HERE) -> dict:
    """One traced window of the cell, run by ``run.py``'s own clients: the
    span table, the readings, the idle gaps by span, the accepted readers
    on the same merged trace, and, for each of the cell's metrics that read
    kernels by name, those kernels' device ms a unit by span."""
    import shutil
    from unittest import mock

    from benchmark import run, spec, worker
    cell = spec.cell(name, root, here)
    run.cache_env(root)
    if device.startswith("cuda"):
        from instag_torch import kernels
        kernels.build(run.KERNEL_SOURCES)
    run_dir = tempfile.mkdtemp(prefix="bench-spans-")
    clients = None
    try:
        with mock.patch.object(worker, "process_main", _process_main):
            clients = run.Clients(cell, seed, device, True, run_dir, True)
        clients.gather("warm", run.WARM_TIMEOUT_S)
        t0 = time.monotonic() + run.START_LEAD_S
        clients.send_all(dict(t0=t0, t_end=t0 + seconds))
        done = clients.gather("done", seconds + run.WARM_TIMEOUT_S)
        summaries = []
        for i, s in enumerate(run._load_traces(run_dir, cell["clients"])):
            with open(_fields_path(run_dir, i), "rb") as f:
                summaries.append(dict(s, **pickle.load(f)))
    finally:
        if clients is not None:
            clients.close()
        shutil.rmtree(run_dir, ignore_errors=True)
    merged = merge(summaries)
    rctx = dict(cell=cell, merged=merged, done=done, counts={},
                nvml_util=None)
    # readers that need the reference's counts read None here
    accepted = {m["name"]: spec.reader(m["name"], here).read(rctx)
                for m in cell["per_layer"]}
    table = merged["spans"]
    rate = sum(d["trace_units"] / s for d, s in zip(done, merged["spans_s"]))
    return dict(workload=name, seed=seed, card=run.power_limit(),
                traced_units=[d["trace_units"] for d in done],
                traced_rate=rate, busy_s=merged["busy_s"],
                window_s=merged["window_s"], readings=readings(table),
                accepted=accepted, outside_share=table["outside_share"],
                named_kernels_by_span={
                    m: share_under(table, NAMED_KERNELS[m])
                    for m in accepted if m in NAMED_KERNELS},
                idle_gaps_by_span=merged["idle_gaps_by_span"],
                idle_gaps=merged["breakdown"]["idle_gaps"],
                clients=table["clients"], spans=table["spans"],
                device_ops=sorted(table["device_ops"].items(),
                                  key=lambda kv: -kv[1])[:40])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out", default="", help="also write the result here")
    a = ap.parse_args(argv)
    res = run_cell(a.workload, a.seed, a.seconds)
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)
    brief = {k: v for k, v in res.items()
             if k not in ("spans", "device_ops")}
    print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
