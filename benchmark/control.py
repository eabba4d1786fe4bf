"""The control of ``correct``: the plain reference computed in TF32 (the
precision below the configuration's float32 with TF32 off) put in the
program's place, judged by the same comparison and the same verdict as a
run (``run.judge`` against ``limits/<cell>.json``), on the frames or steps
a run of the cell samples (per client, drawn from the seed). Run on the
card, one line per seed:

    python3 benchmark/control.py --workload few-ds.clip-streams --seeds 1 2 3

The limits hold only if every seed's control comes out not correct.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import spec  # noqa: E402
from benchmark.run import cache_env, judge  # noqa: E402


def control(name: str, seed: int, device: str = "cuda",
            root: str = ROOT, here: str = spec.HERE) -> dict:
    """One seed's control: ``correct``, as a run's verdict reads it, and
    each compared number beside its limit."""
    cell = spec.cell(name, root, here)
    drv = spec.driver(cell["kind"])
    cache_env(root)
    import torch
    samples = drv.control_samples(cell, seed)
    numbers = drv.check(cell, seed, samples, torch.device(device),
                        tf32=True)["numbers"]
    correct, checks = judge(cell["limits"], numbers)
    return dict(correct=correct, checks=checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    for s in a.seeds:
        print(json.dumps(dict(seed=s, **control(a.workload, s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
