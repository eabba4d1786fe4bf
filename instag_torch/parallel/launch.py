"""Start W ranks on one host without ``torchrun``: ``spawn(fn, W)`` runs
``fn(rank, group, device, *args)`` in W fresh processes joined by a
``file://`` rendezvous (no port is needed, so concurrent launches cannot
collide), and returns each rank's result in rank order (``start`` returns
at once, and its ``join()`` collects them). Each rank uses ``device``:
by default ``"cuda"``, one card a rank over NCCL (raising without a
card), or a CUDA device every rank shares over gloo, or ``"cpu"``.

No failure passes quietly: a rank that raises makes ``spawn`` raise with
that rank's traceback, and ranks still running when ``timeout`` runs out
are killed and ``spawn`` raises ``TimeoutError``.
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch
import torch.multiprocessing as mp

from ..device import resolve_device
from .mesh import init_distributed, shutdown


def _entry(rank: int, world_size: int, init_file: str, device: str,
           backend: str | None, call: str, out: str) -> None:
    try:
        fn, args = torch.load(call, weights_only=False)
        group, dev = init_distributed(device, init_method=f"file://{init_file}",
                                      rank=rank, world_size=world_size,
                                      backend=backend)
        result = fn(rank, group, dev, *args)
        torch.save(result, out)
        shutdown()
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


class Ranks:
    """W ranks started by ``start``; ``join()`` waits for them (under the
    time limit counted from the start) and returns their results (again,
    on a later call)."""

    def __init__(self, fn, world_size: int, args: tuple, device: str,
                 backend: str | None, timeout: float):
        resolve_device(device)          # no card for "cuda": raise here
        ctx = mp.get_context("spawn")
        self.world_size, self.timeout = world_size, timeout
        self._tmp = tempfile.TemporaryDirectory()
        init = os.path.join(self._tmp.name, "rendezvous")
        # the call travels in a file: through the spawn's pipe, a large
        # one would hold each start until that rank had imported and read
        call = os.path.join(self._tmp.name, "call.pt")
        torch.save((fn, args), call)
        self.outs = [os.path.join(self._tmp.name, f"rank{r}.pt")
                     for r in range(world_size)]
        self.procs = [ctx.Process(target=_entry, args=(
            r, world_size, init, device, backend, call, self.outs[r]))
            for r in range(world_size)]
        for p in self.procs:
            p.start()
        self.deadline = time.monotonic() + timeout
        self._results = None

    def join(self) -> list:
        if self._results is not None:
            return self._results
        procs, outs = self.procs, self.outs
        try:
            running = list(procs)
            while running and time.monotonic() < self.deadline:
                wait([p.sentinel for p in running],
                     max(0.0, self.deadline - time.monotonic()))
                running = [p for p in running if p.is_alive()]
                if any(p.exitcode not in (None, 0) for p in procs):
                    break       # a rank failed: the others would wait on it
            late = [r for r, p in enumerate(procs)
                    if p.is_alive() and all(q.exitcode in (None, 0)
                                            for q in procs)]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            if late:
                raise TimeoutError(f"ranks {late} of {self.world_size} still "
                                   f"ran after {self.timeout:.0f} s and were "
                                   "killed")
            failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed:
                errs = [open(outs[r] + ".err").read() for r in failed
                        if os.path.exists(outs[r] + ".err")]
                raise RuntimeError(
                    f"ranks {failed} of {self.world_size} failed (exit codes "
                    f"{[procs[r].exitcode for r in failed]}):\n"
                    + "\n".join(errs))
            self._results = [torch.load(o, weights_only=False) for o in outs]
            return self._results
        finally:
            self._tmp.cleanup()


def start(fn, world_size: int, args: tuple = (), device: str = "cuda",
          backend: str | None = None, timeout: float = 300.0) -> Ranks:
    """Start ``fn(rank, group, device, *args)`` on ``world_size`` ranks and
    return at once; ``fn`` must be importable by name (a module-level
    function) and its result picklable by ``torch.save``."""
    return Ranks(fn, world_size, args, device, backend, timeout)


def spawn(fn, world_size: int, args: tuple = (), device: str = "cuda",
          backend: str | None = None, timeout: float = 300.0) -> list:
    """``start(...).join()``: the ranks' results in rank order."""
    return start(fn, world_size, args, device, backend, timeout).join()
