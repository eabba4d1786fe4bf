"""Phase 14 of chip_smoke.py on several fresh trained clouds at once, on
the card: each run is a process of its own that calls
``chip_smoke.pretraining`` (the two identities written, the pre-training
loops, then one face motion step through the kernels against plain
autograd on the trained cloud of identity 0, both fed one cotangent, and
the rest of the phase). The scatter's atomics make each run's cloud
differ, so each run's step check sees another cloud.

    python3 scripts/probe_pretrain_step.py [--runs 3] [--timeout 1500]
        [--out DIR]

Builds the kernels once, starts the runs together, and prints each run's
step-check lines (the worst fraction of the tolerance and the L1
residuals whose signs differ between the two renders) and exit code,
beside the card's name and power limit; exits non-zero if a run failed.
Each run's whole log goes to ``DIR/probe_pretrain_step_<k>.log`` (default:
the system's temporary directory).
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child() -> None:
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as C
    dev = torch.device("cuda")
    keep = []
    C.pretraining(sys.argv[2], dev, keep)
    for tmp, _ in keep:
        tmp.cleanup()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--timeout", type=float, default=1500.0)
    parser.add_argument("--out", default=tempfile.gettempdir(),
                        help="where each run's whole log goes")
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("probe_pretrain_step: no CUDA device")
        return 2
    from instag_torch import kernels
    import chip_smoke as C
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    kernels.build(C.SOURCES)
    print(f"[{card}] kernels built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = args.out
    os.makedirs(out, exist_ok=True)
    runs = []
    for k in range(args.runs):
        log = open(os.path.join(out, f"probe_pretrain_step_{k}.log"), "w")
        runs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", card],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log))
    failed = 0
    for k, (proc, log) in enumerate(runs):
        try:
            proc.wait(max(1.0, args.timeout - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log.close()
        with open(log.name) as f:
            lines = f.read().splitlines()
        keep = [x for x in lines if "kernels vs plain autograd" in x
                or "L1 residuals" in x or "disagrees" in x]
        print(f"[{card}] run {k}: exit {proc.returncode} after "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for x in keep or lines[-10:]:
            print(f"  {x.strip()}", flush=True)
        failed += proc.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child()
    else:
        sys.exit(main())
