"""One client process of a cell: pinned to its own core with one intra-op
thread, it builds its inputs and the program's objects from the seed,
warms them, reports ready, starts at the parent's signal, runs the window,
and writes its sample and (traced) summary into the run directory.

``chan`` has ``send`` and ``recv`` (a ``multiprocessing`` connection, or
queues when the tests run clients as threads)."""

from __future__ import annotations

import os
import sys
import time
import traceback

FORBIDDEN = ("jax", "jaxlib", "flax", "instag_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's,
    jaxlib's, flax's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(chan, cell: dict, seed: int, index: int, core, device: str,
         trace: bool, run_dir: str) -> None:
    entered = time.monotonic()
    try:
        if core is not None:
            os.sched_setaffinity(0, {core})
        import numpy as np
        import torch

        from . import spec
        from .trace import Recorder, SpanBarrier
        torch.set_num_threads(1)
        dev = torch.device(device)
        cuda = dev.type == "cuda"
        if cuda:
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        t = time.monotonic()
        client = spec.driver(cell["kind"]).Client(cell, seed, index, dev)
        client.rec = Recorder(SpanBarrier(run_dir, index, cell["clients"])) \
            if trace else None
        client.warm()
        if cuda:
            torch.cuda.synchronize(dev)
        chan.send(dict(index=index, warm=True, entered=entered, ready=t,
                       setup_s=time.monotonic() - t,
                       marks=[(k, v - t) for k, v in getattr(
                           client, "marks", [])]))
        go = chan.recv()
        if go.get("stop"):
            return
        out = client.run(go["t0"], go["t_end"])
        rec = client.rec
        if cuda:
            torch.cuda.synchronize(dev)
            out["memory_peak_bytes"] = torch.cuda.max_memory_reserved(dev)
        client.finish(os.path.join(run_dir, f"sample_{index}.npz"))
        if rec is not None and rec.prof is not None:
            s = rec.summary()
            np.savez(os.path.join(run_dir, f"trace_{index}.npz"),
                     names=np.array(s["names"] or [""], dtype=str),
                     dev=s["dev"], host=s["host"],
                     launches=s["launches"], span=np.array(s["span"]))
        out.update(index=index, done=True, forbidden=forbidden_modules())
        chan.send(out)
    except BaseException:
        chan.send(dict(index=index, error=traceback.format_exc()))
        raise


def process_main(conn, *args) -> None:
    """Entry of a spawned client process."""
    try:
        main(conn, *args)
    except BaseException:
        sys.exit(1)
    finally:
        conn.close()
