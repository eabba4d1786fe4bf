"""Run one cell of ``BENCHMARK.json`` once on this machine's card and print
its result as the last line of standard output:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The parent starts the cell's clients (``worker.py``), each its own process
on its own core, waits until all have built their inputs from the seed and
warmed their shapes (``setup_s`` ends there), starts them together, and
counts what they completed inside the common window of ``--seconds``. With
``--trace 1`` each client profiles a span of the window and the per-layer
metrics are read from the merged trace. Then, with the clients gone, the
parent judges the clients' sampled outputs against the plain reference
(``correct``). It exits non-zero, printing no result, without a card, with
fewer cards than the cell asks for, without the program, or when JAX or the
JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import spec  # noqa: E402
from benchmark.worker import FORBIDDEN, forbidden_modules  # noqa: E402

KERNEL_SOURCES = ["composite_fwd", "composite_bwd", "scatter_add"]
WARM_TIMEOUT_S = 600.0
START_LEAD_S = 0.5


class Refused(RuntimeError):
    """A run that must print no result."""


def cache_env(root: str) -> None:
    """Every cache of the run at a fixed path inside the checkout, one
    intra-op thread per client, and no JAX behind any library."""
    cache = os.path.join(root, "benchmark", ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


class _ThreadChan:
    def __init__(self, inbox, outbox):
        self.inbox, self.outbox = inbox, outbox

    def send(self, msg):
        self.outbox.put(msg)

    def recv(self):
        return self.inbox.get()


class Clients:
    """The cell's clients, as processes (the benchmark) or threads (the
    tests, where the program can be patched underneath)."""

    def __init__(self, cell, seed, device, trace, run_dir, spawn: bool):
        from benchmark import worker
        self.n = cell["clients"]
        self.spawn = spawn
        self.procs, self.chans = [], []
        cores = sorted(os.sched_getaffinity(0))
        if spawn and len(cores) < self.n + 2:
            raise Refused(f"{self.n} clients need {self.n + 2} usable cores,"
                          f" {len(cores)} are usable")
        if spawn:
            import multiprocessing as mp
            ctx = mp.get_context("spawn")
            for i in range(self.n):
                parent, child = ctx.Pipe()
                p = ctx.Process(target=worker.process_main, args=(
                    child, cell, seed, i, cores[2 + i], device, trace,
                    run_dir), daemon=True)
                p.start()
                child.close()
                self.procs.append(p)
                self.chans.append(parent)
        else:
            self.replies = queue.Queue()
            for i in range(self.n):
                inbox = queue.Queue()
                chan = _ThreadChan(inbox, self.replies)
                th = threading.Thread(target=self._thread, args=(
                    worker.main, chan, cell, seed, i, None, device, trace,
                    run_dir), daemon=True)
                th.start()
                self.procs.append(th)
                self.chans.append(_ThreadChan(None, inbox))

    @staticmethod
    def _thread(fn, *args):
        try:
            fn(*args)
        except BaseException:
            pass            # the client has sent its traceback

    def gather(self, key: str, timeout: float) -> list:
        """One reply from each client, holding ``key``; raise on an error
        or on the deadline."""
        got, deadline = {}, time.monotonic() + timeout
        while len(got) < self.n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"clients did not report {key!r} in "
                                   f"{timeout:.0f} s")
            if self.spawn:
                from multiprocessing.connection import wait
                waiting = [c for i, c in enumerate(self.chans)
                           if i not in got]
                ready = wait(waiting, timeout=left)
                msgs = []
                for c in ready:
                    try:
                        msgs.append(c.recv())
                    except EOFError:
                        raise RuntimeError("a client exited without a reply")
            else:
                try:
                    msgs = [self.replies.get(timeout=left)]
                except queue.Empty:
                    continue
            for m in msgs:
                if "error" in m:
                    raise RuntimeError(f"client {m['index']} failed:\n"
                                       f"{m['error']}")
                got[m["index"]] = m
        return [got[i] for i in range(self.n)]

    def send_all(self, msg: dict) -> None:
        for c in self.chans:
            c.send(msg)

    def close(self, timeout: float = 60.0) -> None:
        """Wait for every client to end; end those that do not."""
        for p in self.procs:
            p.join(timeout)
        for p in self.procs:
            if self.spawn and p.is_alive():
                p.kill()
                p.join(10)
        if self.spawn:
            for c in self.chans:
                c.close()


class NvmlSampler:
    """``nvidia-smi``'s ``utilization.gpu`` sampled every 100 ms beside
    the traced window (a cross-check of the trace's idle share)."""

    def __init__(self):
        self.proc = None
        if shutil.which("nvidia-smi"):
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits", "-lms", "100"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self):
        if self.proc is None:
            return None
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = [float(x) for x in out.split() if x.strip().isdigit()]
        return sum(vals) / len(vals) if vals else None


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _load_samples(run_dir: str, n: int) -> list:
    import numpy as np
    out = []
    for i in range(n):
        with np.load(os.path.join(run_dir, f"sample_{i}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def _load_traces(run_dir: str, n: int) -> list:
    import numpy as np
    out = []
    for i in range(n):
        with np.load(os.path.join(run_dir, f"trace_{i}.npz")) as z:
            out.append(dict(names=[str(x) for x in z["names"]],
                            dev=z["dev"], host=z["host"],
                            launches=int(z["launches"]),
                            span=[int(x) for x in z["span"]]))
    return out


def judge(limits: dict, numbers: dict):
    """``correct`` and each compared number beside its limit: correct
    when the cell has limits and no number lies above its own."""
    checks = {k: dict(value=numbers[k], limit=lim)
              for k, lim in limits.items()}
    return (bool(limits) and all(c["value"] <= c["limit"]
                                 for c in checks.values())), checks


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", spawn: bool = True,
             root: str = ROOT, here: str = HERE,
             t_start: float = T_START) -> dict:
    """One run of the cell. On ``cuda`` the result carries the metrics;
    elsewhere (the tests) only ``correct`` and the compared numbers."""
    cell = spec.cell(name, root, here)
    drv = spec.driver(cell["kind"])
    cache_env(root)
    import torch
    cuda = device.startswith("cuda")
    if cuda:
        from instag_torch import kernels
        kernels.build(KERNEL_SOURCES)
    run_dir = tempfile.mkdtemp(prefix="bench-run-")
    clients = None
    try:
        clients = Clients(cell, seed, device, trace, run_dir, spawn)
        warm = clients.gather("warm", WARM_TIMEOUT_S)
        setup_s = time.monotonic() - t_start
        t0 = time.monotonic() + START_LEAD_S
        t_end = t0 + seconds
        nvml = NvmlSampler() if (trace and cuda) else None
        clients.send_all(dict(t0=t0, t_end=t_end))
        try:
            done = clients.gather("done", seconds + WARM_TIMEOUT_S)
        finally:
            util = nvml.stop() if nvml else None
        clients.close()
        bad = sorted({m for d in done for m in d["forbidden"]}
                     | set(forbidden_modules()))
        if bad:
            raise Refused(f"modules of JAX or the JAX package loaded: {bad}")
        units = sum(d["units"] for d in done)
        samples = _load_samples(run_dir, cell["clients"])
        merged = None
        if trace:
            from benchmark import trace as tr
            merged = tr.merge(_load_traces(run_dir, cell["clients"]))
        t_check = time.monotonic()
        verdict = drv.check(cell, seed, samples, torch.device(device))
        check_s = time.monotonic() - t_check
    finally:
        if clients is not None:
            clients.close(timeout=5)
        shutil.rmtree(run_dir, ignore_errors=True)
    correct, checks = judge(cell["limits"], verdict["numbers"])
    res = dict(correct=correct, attempted=sum(d["attempted"] for d in done),
               failed=sum(d.get("failed", 0) for d in done))
    info = dict(verdict["numbers"], clients=cell["clients"],
                units=[d["units"] for d in done],
                jobs=[d["jobs"] for d in done if "jobs" in d] or None,
                check_s=round(check_s, 2),
                # per client: seconds from the parent's start to its entry,
                # to its card (imports, CUDA), to warm
                setup_parts_s=[[round(w["entered"] - t_start, 2),
                                round(w["ready"] - t_start, 2),
                                round(w["ready"] - t_start + w["setup_s"], 2)]
                               for w in warm],
                setup_marks_s=[[m[0], round(m[1], 2)]
                               for m in warm[0]["marks"]])
    if cuda:
        metrics = {}
        if not trace:
            rate = dict(value=units / seconds,
                        unit=_unit(cell, drv.RATE_METRIC))
            metrics[drv.RATE_METRIC] = rate
            metrics["setup_s"] = dict(value=setup_s, unit="s")
        else:
            ctx = dict(cell=cell, merged=merged, done=done,
                       counts=verdict["counts"], nvml_util=util)
            for m in cell["per_layer"]:
                v = spec.reader(m["name"], here).read(ctx)
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
        res["metrics"] = metrics
        dev = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                   count=cell["chips"],
                   memory_peak_bytes=int(sum(d["memory_peak_bytes"]
                                             for d in done)))
        if trace:
            dev.update(busy_s=merged["busy_s"], window_s=merged["window_s"])
            res["breakdown"] = merged["breakdown"]
            traced = sum(d["trace_units"] for d in done)
            info["device_ms_per_unit"] = (
                sum(merged["device_s"].values()) * 1e3 / traced
                if traced else None)
            info["nvml_utilization_pct"] = util
        res["device"] = dev
        info["card"] = power_limit()
    res["info"] = info
    res["checks"] = checks
    return res


def _unit(cell, metric):
    return {m["name"]: m["unit"] for m in cell["end_to_end"]}[metric]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    try:
        try:
            import instag_torch  # noqa: F401
        except ImportError as e:
            raise Refused(f"the program (instag_torch) is not here: {e}")
        import torch
        want = spec.cell(a.workload)["chips"]
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark measures the card")
        if torch.cuda.device_count() < want:
            raise Refused(f"the cell asks for {want} cards, "
                          f"{torch.cuda.device_count()} are here")
        res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except (Refused, KeyError, FileNotFoundError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for k, c in res["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    if not res["checks"]:
        print("check: no limits for this cell", file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
