"""Phase probe of the port's composite and scatter-add kernels on one NVIDIA
GPU, run from the repository root:

    python3 scripts/probe_torch_kernels.py [--ab DIR]

Builds instag_torch/csrc/composite_fwd.cu, composite_bwd.cu and
scatter_add.cu as they are, and copies cut short at a phase (a cut returns
or skips ahead at the phase's comment, so a cut copy times what comes before
it; what it writes is meaningless; no_B skips one serial phase), into
instag_torch/build/probe/. The forward's copies with a fixed split (S CTAs a
busy tile, the choice the kernel otherwise makes from the busy-tile count)
time each S on the face cloud. With --ab DIR, the csrc/ directory of another
checkout (for example ``git archive <rev> instag_torch/csrc | tar -x -C
.chip_ab/old`` and ``--ab .chip_ab/old/instag_torch/csrc``), it also builds
that directory's three kernels, times old, new, new, old, and asserts that
the new forward's T_final row is bitwise equal to the old one's and every
other row within 1e-5, and that the two backwards give the same bits. Inputs are chip_smoke.py's face cloud (36 busy tiles)
and wide cloud (every tile busy), the forward at the serving shape (C=8,
A=0) and the training shape (C=8, A=2), the backward and scatter at the
training shape (K=256, 512x512). Every time is chip_smoke.cuda_ms's
CUDA-event median in ms, printed beside the card's name and power limit,
with PyTorch's fill of dfeats and of the accumulator and index_add_ on the
pre-masked columns as yardsticks.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
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

# the forward's cuts (of its split kernel): cut name -> edits, each a marker
# comment and the code put before it
NO_B = ("// (B) the carry", "if (lane < 0)\n")
NO_C = ("// (C) weights and sums", "if (all_done) break;\ncontinue;\n")
FWD_CUTS = {
    "count": [("// ---- the busy tiles' parts", "return;\n")],
    "lookup": [("// ---- walk this CTA's part",
                "if (n < 0) o_t[0] = 0.f;\ncontinue;\n")],
    "staged": [("// ---- the segments", "continue;\n")],
    "A": [NO_B, NO_C],
    "AB": [NO_C],
    "walk": [("// ---- the lanes' partial sums",
              "__pipeline_wait_prior(0);\n"
              "if (wsum == 12345.f) o_t[tid] = acc[0];\nreturn;\n")],
    "no_B": [NO_B],
}
SPLIT_CHOICE = "split_for(n_busy, resident)"   # in both kernels
SPLITS = (1, 2, 4, 8, 16)
BOUNDS = "kSplitCtas = 3;"   # resident split CTAs an SM the registers allow
MIN_CTAS = (2, 4)


def cut_source(src: str, name: str) -> str:
    edits = {"sweep": [CUT_SUMS, (BEFORE_COMBINE, CUT_COMBINE)],
             "sums": [(BEFORE_COMBINE, CUT_COMBINE)]}.get(name, [CUTS.get(name)])
    return _edit(src, edits)


def _edit(src: str, edits) -> str:
    for marker, code in edits:
        if src.count(marker) != 1:
            raise SystemExit(f"marker not found once: {marker!r}")
        src = src.replace(marker, code + marker)
    return src


def fwd_variants(src: str) -> dict[str, str]:
    """The forward's phase cuts, its fixed-split copies and its copies with
    more registers for the split kernel."""
    out = {f"fwd_{name}": _edit(src, edits) for name, edits in FWD_CUTS.items()}
    for marker in (SPLIT_CHOICE, BOUNDS):
        if marker not in src:
            raise SystemExit(f"not found: {marker!r}")
    for s in SPLITS:
        out[f"fwd_S{s}"] = src.replace(SPLIT_CHOICE, str(s))
    for m in MIN_CTAS:
        out[f"fwd_LB{m}"] = src.replace(BOUNDS, f"kSplitCtas = {m};")
    return out


def ptxas_summary(log: str) -> list[str]:
    """Registers, spill stores and static shared memory of each kernel at
    C+A = 8 and 10 (the serving and training shapes), and the largest spill
    over all of its instances."""
    rows, worst = [], {}
    for block in log.split("Compiling entry function '")[1:]:
        m = re.search(r"\d+([a-z_]+kernel)ILi(\d+)E", block)
        regs = re.search(r"Used (\d+) registers", block)
        if not (m and regs):
            continue
        spill = int(re.search(r"(\d+) bytes spill stores", block).group(1))
        smem = re.search(r"(\d+) bytes smem", block)
        worst[m[1]] = max(worst.get(m[1], 0), spill)
        if m[2] in ("8", "10"):
            rows.append(f"{m[1]}<{m[2]}> {regs[1]} registers, {spill} B "
                        f"spilled, {smem[1] if smem else 0} B smem")
    return rows + [f"{k}: at most {v} B spilled over C+A 1..16"
                   for k, v in worst.items()]


def build_all(sources: dict[str, str], out: str) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all started together; prints ptxas_summary of
    each source that is not a phase cut."""
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
        if v.split("_")[-1] in ("fwd", "bwd", "ab", "LB2", "LB4"):
            for row in ptxas_summary(log):
                print(f"  ptxas {v}: {row}", flush=True)
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
    sources = {"fwd": os.path.join(kernels.CSRC, "composite_fwd.cu"),
               "bwd": os.path.join(kernels.CSRC, "composite_bwd.cu"),
               "scatter": os.path.join(kernels.CSRC, "scatter_add.cu")}
    with open(sources["bwd"]) as f:
        bwd_src = f.read()
    with open(sources["fwd"]) as f:
        variants = fwd_variants(f.read())
    for name in ("staged", "pass1", "sweep", "sums", "no_B", "no_C2"):
        variants[f"bwd_{name}"] = cut_source(bwd_src, name)
    for v, text in variants.items():
        path = os.path.join(out, f"{v}.cu")
        with open(path, "w") as f:
            f.write(text)
        sources[v] = path
    if args.ab:
        sources["fwd_ab"] = os.path.join(args.ab, "composite_fwd.cu")
        sources["bwd_ab"] = os.path.join(args.ab, "composite_bwd.cu")
        sources["scatter_ab"] = os.path.join(args.ab, "scatter_add.cu")
    libs = build_all(sources, out)
    P, I = ctypes.c_void_p, ctypes.c_int
    argtypes = {"fwd": [P, P, P, I, I, I, I, I, P],
                "bwd": [P, P, P, P, I, I, I, I, I, I, P],
                "scatter": [P, P, P, P, I, I, I, I, P]}
    names = {"fwd": "composite_fwd", "bwd": "composite_bwd",
             "scatter": "scatter_add"}
    launch = {}
    for v, lib in libs.items():
        kind = v.split("_")[0]
        fn = getattr(lib, f"{names[kind]}_launch")
        fn.restype = I
        fn.argtypes = argtypes[kind]
        launch[v] = fn

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

    def timed(order, call):
        res = {}
        for v in order:
            if call(v) != 0:
                raise SystemExit(f"{v}: launch failed")
            res.setdefault(v, []).append(round(cs.cuda_ms(lambda: call(v)),
                                               4))
        return res

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

            # ---- the forward, at the serving and the training shape ----
            for n_aux in (0, 2):
                feats, cnt = tile_features(
                    prep.px, prep.py, prep.proj, opac, colors,
                    torch.ones_like(opac), prep.ids, prep.valid,
                    aux_colors=aux[:, :n_aux] if n_aux else None)
                F, T, K = feats.shape
                o = {v: torch.empty((T, 10 + n_aux, 256), device=dev)
                     for v in ("fwd", "fwd_ab", "other")}

                def fwd(v, n_aux=n_aux, feats=feats, cnt=cnt, T=T, K=K):
                    dst = o.get(v, o["other"])
                    return launch[v](feats.data_ptr(), cnt.data_ptr(),
                                     dst.data_ptr(), T, K, cfg.tiles_x, 8,
                                     n_aux, stream())
                order = ["fwd", "fwd"]
                if label == "face":
                    order += [f"fwd_{c}" for c in FWD_CUTS]
                    order += [f"fwd_S{s}" for s in SPLITS]
                order += [f"fwd_LB{m}" for m in MIN_CTAS]
                if args.ab:
                    order = ["fwd_ab", *order, "fwd_ab"]
                res = timed(order, fwd)
                print(f"[{card}] {label} cloud composite_fwd C=8 A={n_aux} "
                      f"busy tiles {int((cnt > 0).sum())}, sum cnt "
                      f"{int(cnt.sum())} ms: {res}", flush=True)
                if args.ab:
                    torch.cuda.synchronize()
                    new, old = o["fwd"], o["fwd_ab"]
                    tf = 8 + 1  # the T_final row
                    if not torch.equal(new[:, tf], old[:, tf]):
                        raise SystemExit(f"{label} A={n_aux}: T_final rows "
                                         f"differ")
                    err = float((new - old).abs().max())
                    if not err <= 1e-5:
                        raise SystemExit(f"{label} A={n_aux}: new and old "
                                         f"forward differ by {err}")
                    print(f"  {label} A={n_aux}: T_final rows bitwise equal; "
                          f"max |new - old| {err:.2e}", flush=True)

            # ---- the backward and the scatter, at the training shape ----
            g = torch.randn((T, 12, 256), device=dev, generator=gen)
            d = torch.empty_like(feats)

            def bwd(v, feats=feats, cnt=cnt, F=F, T=T, K=K):
                return launch[v](feats.data_ptr(), cnt.data_ptr(),
                                 g.data_ptr(), d.data_ptr(), F, T, K,
                                 cfg.tiles_x, 8, 2, stream())
            order = ["bwd", "bwd_staged", "bwd_pass1", "bwd_sweep",
                     "bwd_sums", "bwd_no_B", "bwd_no_C2", "bwd"]
            if args.ab:
                order = ["bwd_ab", *order, "bwd_ab"]
            res = timed(order, bwd)
            res["fill dfeats"] = [round(cs.cuda_ms(lambda: d.zero_()), 4)]
            print(f"[{card}] {label} cloud composite_bwd ms: {res}",
                  flush=True)
            if args.ab:  # the same arithmetic: the same bits
                assert bwd("bwd_ab") == 0
                old = d.clone()
                assert bwd("bwd") == 0
                if not torch.equal(d, old):
                    raise SystemExit(f"{label}: new and old backward differ")
                print(f"  {label}: composite_bwd bitwise equal to the old",
                      flush=True)

            assert bwd("bwd") == 0
            ids, n = prep.ids.contiguous(), st.capacity
            acc = torch.empty((F, n), device=dev)

            def scatter(v):
                return launch[v](d.data_ptr(), ids.data_ptr(),
                                 cnt.data_ptr(), acc.data_ptr(), F, T, K, n,
                                 stream())
            order = ["scatter", "scatter"]
            if args.ab:
                order = ["scatter_ab", *order, "scatter_ab"]
            res = timed(order, scatter)
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
