"""The traced run's reading of ``torch.profiler``: each client process
records a compact summary of its traced span (device operations with their
times, the host's launches, the host operations that were running), and
the parent merges the clients' summaries into one card's view: the union
of their device intervals (the card is busy when any client's operation
runs), device time by operation name, and the card's idle gaps by what the
host of the client that launched next was doing.

Kineto stamps host and device events on one clock, the host's epoch
nanoseconds, so the clients' summaries line up. The clients' spans overlap
by construction: each client marks its start in the run directory, and
none stops before every client has started and ``trace_s`` has passed
since the last start (a profiler can take seconds to start while six
processes start theirs).
"""

from __future__ import annotations

import os
import re
import time

import numpy as np

LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaGraphLaunch"
                    r"|cudaLaunchCooperativeKernel)")
TOP = 10


class SpanBarrier:
    """The clients' traced spans, in step: ``mark()`` once a client traces;
    ``may_stop(trace_s)`` once every client of the run has marked and
    ``trace_s`` seconds have passed since the last of them did."""

    def __init__(self, run_dir: str, index: int, clients: int):
        self.path = os.path.join(run_dir, "span_start_{}")
        self.index, self.clients = index, clients
        self.last = None

    def mark(self) -> None:
        tmp = self.path.format(self.index) + ".tmp"
        with open(tmp, "w") as f:
            f.write(repr(time.time()))
        os.replace(tmp, self.path.format(self.index))

    def may_stop(self, trace_s: float) -> bool:
        if self.last is None:
            starts = []
            for i in range(self.clients):
                try:
                    with open(self.path.format(i)) as f:
                        starts.append(float(f.read()))
                except FileNotFoundError:
                    return False
            self.last = max(starts)
        return time.time() >= self.last + trace_s


class Recorder:
    """``start()``/``stop()`` around the traced span (each after the device
    is synchronised), then ``summary()`` once the window has closed. The
    start is marked on the ``barrier`` for the other clients, and
    ``may_stop(trace_s)`` says when the span may end."""

    def __init__(self, barrier: SpanBarrier):
        self.prof = None
        self.span = None
        self.barrier = barrier

    def prime(self) -> None:
        """One empty profile during set-up, so that the profiler's device
        tracing is initialised before the window (in the thread that will
        trace)."""
        self._profile().stop()

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def start(self) -> None:
        self.prof = self._profile()
        self.span = [time.time_ns(), None]
        self.barrier.mark()

    def may_stop(self, trace_s: float) -> bool:
        return self.barrier.may_stop(trace_s)

    @property
    def on(self) -> bool:
        """Tracing, between ``start()`` and ``stop()``."""
        return self.prof is not None and self.span[1] is None

    def stop(self) -> None:
        self.span[1] = time.time_ns()
        self.prof.stop()

    def summary(self) -> dict:
        """Device operations (name index, start, end), launch count, host
        operations (name index, start, end) of the traced span."""
        from torch.autograd import DeviceType
        names: dict[str, int] = {}

        def nid(n):
            return names.setdefault(n, len(names))
        dev, host, launches = [], [], 0
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    dev.append((nid(name), s, s + d))
            elif LAUNCH.match(name):
                launches += 1
            elif not name.startswith(("cuda", "cu", "Activity Buffer")):
                host.append((nid(name), s, s + d))
        arr = lambda x: np.asarray(x, np.int64).reshape(-1, 3)
        return dict(names=list(names), dev=arr(dev), host=arr(host),
                    launches=launches, span=self.span)


def union_busy(intervals: np.ndarray, lo: int, hi: int):
    """Seconds in [lo, hi] covered by any interval, and the gaps
    (start, end) between the merged intervals, in ns."""
    iv = np.clip(intervals, lo, hi)
    iv = iv[iv[:, 1] > iv[:, 0]]
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    busy, gaps, cur_s, cur_e = 0, [], None, lo
    for s, e in iv:
        if cur_s is None:
            if s > lo:
                gaps.append((lo, s))
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if cur_e < hi:
        gaps.append((cur_e, hi))
    return busy / 1e9, gaps


def _host_at(host: np.ndarray, names, t: int) -> str:
    """The innermost host operation running at ``t`` (the latest-started of
    those that cover it), or the time between operations."""
    if len(host) == 0:
        return "_host_between_operations_"
    i = np.searchsorted(host[:, 1], t, side="right")
    best = None
    for j in range(i - 1, max(-1, i - 400), -1):
        if host[j, 2] >= t:
            best = j
            break
    return names[host[best, 0]] if best is not None \
        else "_host_between_operations_"


def merge(summaries: list[dict]) -> dict:
    """One card's view of the clients' traced spans, over the span all of
    them traced: busy and window seconds, device seconds by name over each
    client's whole span, launches, and the largest idle gaps by what the
    host of the next client to run was doing."""
    lo = max(s["span"][0] for s in summaries)
    hi = min(s["span"][1] for s in summaries)
    if hi <= lo:
        raise RuntimeError("the clients' traced spans do not overlap")
    by_name: dict[str, float] = {}
    devs = []
    for c, s in enumerate(summaries):
        host = s["host"][np.argsort(s["host"][:, 1], kind="stable")]
        s["_host"] = host
        for n, a, b in s["dev"]:
            key = s["names"][n]
            by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e9
        if len(s["dev"]):
            devs.append(np.column_stack([s["dev"][:, 1:],
                                         np.full(len(s["dev"]), c)]))
    allv = np.concatenate(devs) if devs else np.zeros((0, 3), np.int64)
    busy, gaps = union_busy(allv[:, :2], lo, hi)
    starts = allv[np.argsort(allv[:, 0], kind="stable")] if len(allv) else allv
    idle: dict[str, float] = {}
    for g0, g1 in gaps:
        k = np.searchsorted(starts[:, 0], g1, side="left") if len(starts) \
            else 0
        if k < len(starts):
            s = summaries[int(starts[k, 2])]
            what = _host_at(s["_host"], s["names"], (g0 + g1) // 2)
        else:
            what = "_after_last_operation_"
        idle[what] = idle.get(what, 0.0) + (g1 - g0) / 1e9
    top = lambda d: sorted(([k, v] for k, v in d.items()),
                           key=lambda kv: -kv[1])[:TOP]
    return dict(busy_s=busy, window_s=(hi - lo) / 1e9,
                spans_s=[(s["span"][1] - s["span"][0]) / 1e9
                         for s in summaries],
                device_s=by_name, launches=sum(s["launches"]
                                               for s in summaries),
                breakdown=dict(device_ops=top(by_name), idle_gaps=top(idle)))


def device_seconds(merged: dict, pattern: str) -> float:
    """Summed device seconds of the operations whose names match."""
    rx = re.compile(pattern)
    return sum(v for k, v in merged["device_s"].items() if rx.search(k))
