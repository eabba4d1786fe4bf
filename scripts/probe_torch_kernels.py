"""Phase probe of the port's backward composite and scatter-add kernels on one
NVIDIA GPU, run from the repository root:

    python3 scripts/probe_torch_kernels.py [--ab DIR]

Builds instag_torch/csrc/composite_bwd.cu and scatter_add.cu as they are,
and copies of composite_bwd.cu cut short at a phase (a cut returns to the
tile loop at the phase's comment, so a cut copy times what comes before it;
what it writes is meaningless; no_B and no_C2 skip one serial phase), into
instag_torch/build/probe/. With
--ab DIR, the csrc/ directory of another checkout (for example
``git archive <rev> instag_torch/csrc | tar -x -C /tmp/old`` and
``--ab /tmp/old/instag_torch/csrc``), it also builds that directory's two
kernels and times old, new, new, old. Inputs are chip_smoke.py's face cloud
(36 busy tiles) and wide cloud (every tile busy) at the training shape
(C=8, A=2, K=256, 512x512). Every time is chip_smoke.cuda_ms's CUDA-event
median in ms, printed beside the card's name and power limit, with
PyTorch's fill of dfeats and of the accumulator and index_add_ on the
pre-masked columns as yardsticks.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from instag_torch import kernels  # noqa: E402

# cut name -> (marker comment in composite_bwd.cu, code put before it)
CUTS = {
    "staged": ("    // ---- pass 1: the forward chain",
               "    if (s_feat[tid] == 12345.f) dfeats[tid] = s_feat[tid + 7];\n"
               "    continue;\n"),
    "pass1": ("    // segments no pixel of this CTA reaches",
              "    if (btf == 12345.f) dfeats[tid] = s_pre[tid * 3];\n"
              "    continue;\n"),
    "no_C2": ("      // (C2) the suffix sum", "      if (lane < 0)\n"),
    "no_B": ("      // (B) the log-T carry", "      if (lane < 0)\n"),
}
BEFORE_COMBINE = "    // ---- the partial sums of the 4 CTAs"
CUT_COMBINE = "    if (S == 12345.f) dfeats[tid] = s_pre[tid * 5];\n    continue;\n"
CUT_SUMS = ("      // (C3) the segment's sums", "      continue;\n")


def cut_source(src: str, name: str) -> str:
    edits = {"sweep": [CUT_SUMS, (BEFORE_COMBINE, CUT_COMBINE)],
             "sums": [(BEFORE_COMBINE, CUT_COMBINE)]}.get(name, [CUTS.get(name)])
    for marker, code in edits:
        if src.count(marker) != 1:
            raise SystemExit(f"marker not found once: {marker!r}")
        src = src.replace(marker, code + marker)
    return src


def build_all(sources: dict[str, str], out: str) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all started together."""
    os.makedirs(out, exist_ok=True)
    procs = {v: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC, "-o",
         os.path.join(out, f"lib{v}.so"), path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for v, path in sources.items()}
    for v, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc {v} failed:\n{log[-4000:]}")
    return {v: ctypes.CDLL(os.path.join(out, f"lib{v}.so")) for v in sources}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ab", help="csrc/ directory of another checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe: no CUDA device")
        return 2
    from instag_torch.bench_utils import synthetic_camera, synthetic_state
    from instag_torch.ops.rasterize import (RasterizeConfig, prepare,
                                            sh_colors, tile_features)
    from instag_torch.render import _masked_features

    out = os.path.join(kernels.BUILD, "probe")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(kernels.CSRC, "composite_bwd.cu")) as f:
        bwd_src = f.read()
    sources = {"bwd": os.path.join(kernels.CSRC, "composite_bwd.cu"),
               "scatter": os.path.join(kernels.CSRC, "scatter_add.cu")}
    for name in ("staged", "pass1", "sweep", "sums", "no_B", "no_C2"):
        path = os.path.join(out, f"composite_bwd_{name}.cu")
        with open(path, "w") as f:
            f.write(cut_source(bwd_src, name))
        sources[f"bwd_{name}"] = path
    if args.ab:
        sources["bwd_ab"] = os.path.join(args.ab, "composite_bwd.cu")
        sources["scatter_ab"] = os.path.join(args.ab, "scatter_add.cu")
    libs = build_all(sources, out)
    P, I = ctypes.c_void_p, ctypes.c_int
    for v, lib in libs.items():
        kind = "scatter_add" if v.startswith("scatter") else "composite_bwd"
        fn = getattr(lib, f"{kind}_launch")
        fn.restype = I
        fn.argtypes = ([P, P, P, P, I, I, I, I, P] if kind == "scatter_add"
                       else [P, P, P, P, I, I, I, I, I, I, P])

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    cfg = RasterizeConfig(cs.SIZE, cs.SIZE, max_per_tile=256)
    cam = synthetic_camera(cs.SIZE, device=dev)
    aux = torch.rand((32768, 4), device=dev,
                     generator=torch.Generator(dev).manual_seed(7))
    gen = torch.Generator(dev).manual_seed(11)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    clouds = [("face", 0, 0.1, 0.004), ("wide", 2, cs.WIDE_SPREAD,
                                         cs.WIDE_SCALE)]
    with torch.no_grad():
        for label, seed, spread, scale in clouds:
            st = synthetic_state(30000, 32768, seed=seed, spread=spread,
                                 scale=scale, device=dev)
            prep = prepare(cfg, st.params.xyz, st.get_scaling(),
                           st.get_rotation(), cam.view_transform,
                           cam.full_proj_transform, cam.camera_center,
                           cam.tanfovx, cam.tanfovy, active=st.alive)
            colors = sh_colors(st.params.xyz, cam.camera_center,
                               _masked_features(st), st.max_sh_degree)
            opac = st.get_opacity().reshape(-1)
            feats, cnt = tile_features(
                prep.px, prep.py, prep.proj, opac, colors,
                torch.ones_like(opac), prep.ids, prep.valid,
                aux_colors=aux[:, :2])
            g = torch.randn((feats.shape[1], 12, 256), device=dev,
                            generator=gen)
            F, T, K = feats.shape
            d = torch.empty_like(feats)
            res = {}
            order = ["bwd", "bwd_staged", "bwd_pass1", "bwd_sweep",
                     "bwd_sums", "bwd_no_B", "bwd_no_C2", "bwd"]
            if args.ab:
                order = ["bwd_ab", *order, "bwd_ab"]
            for v in order:
                def call(fn=libs[v].composite_bwd_launch):
                    return fn(feats.data_ptr(), cnt.data_ptr(), g.data_ptr(),
                              d.data_ptr(), F, T, K, cfg.tiles_x, 8, 2,
                              stream())
                if call() != 0:
                    raise SystemExit(f"{v}: launch failed")
                res.setdefault(v, []).append(round(cs.cuda_ms(call), 4))
            res["fill dfeats"] = [round(cs.cuda_ms(lambda: d.zero_()), 4)]
            print(f"[{card}] {label} cloud composite_bwd ms: {res}",
                  flush=True)

            assert libs["bwd"].composite_bwd_launch(
                feats.data_ptr(), cnt.data_ptr(), g.data_ptr(), d.data_ptr(),
                F, T, K, cfg.tiles_x, 8, 2, stream()) == 0
            ids, n = prep.ids.contiguous(), st.capacity
            acc = torch.empty((F, n), device=dev)
            res = {}
            order = ["scatter", "scatter"]
            if args.ab:
                order = ["scatter_ab", *order, "scatter_ab"]
            for v in order:
                def call(fn=libs[v].scatter_add_launch):
                    return fn(d.data_ptr(), ids.data_ptr(), cnt.data_ptr(),
                              acc.data_ptr(), F, T, K, n, stream())
                if call() != 0:
                    raise SystemExit(f"{v}: launch failed")
                res.setdefault(v, []).append(round(cs.cuda_ms(call), 4))
            vid, gv = ids[prep.valid].long(), d[:, prep.valid]
            res["index_add_"] = [round(cs.cuda_ms(
                lambda: torch.zeros((F, n), device=dev).index_add_(
                    1, vid, gv)), 4)]
            res["fill acc"] = [round(cs.cuda_ms(lambda: acc.zero_()), 4)]
            print(f"[{card}] {label} cloud scatter_add ms: {res}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
