"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA kernel of the serving path, from instag_torch/csrc,
     one nvcc each, started together;
  3. kernels against their plain PyTorch versions on the card, on tile
     features from a real 512x512 projection of the synthetic face cloud;
  4. the serving path at full width (512x512, K=256, face 30000/32768 and
     mouth 10000/16384 splats, deepspeech nets, 8 frames with rotating
     audio windows): finite uint8 [512, 512, 3] frames, the composite
     kernel launched exactly twice per frame, and one frame held against
     the same frame through the plain composite;
  5. times with CUDA events, each beside the card's name and power limit;
  6. one profiled frame: device-busy share, launches, heaviest kernels and
     host operations.
The line before last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, at a 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SIZE = 512
FRAMES = 8
ATOL = 1e-4
WARMUP = 5


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=20, rounds=10, warmup=WARMUP) -> float:
    """Median over ``rounds`` of the mean ms of one call in a run of ``reps``
    back-to-back calls, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def profile_frames(run, n=3, top=8):
    """One trace of ``n`` frames: per-frame wall ms (under the profiler),
    device-kernel ms and launches per frame, and the heaviest kernels and
    host operations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(n):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / n
    by_kernel: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_kernel.setdefault(e.name, []).append(
                e.time_range.elapsed_us() / 1e3)
    dev_ms = sum(map(sum, by_kernel.values())) / n
    launches = sum(map(len, by_kernel.values())) / n
    kernels = sorted(by_kernel.items(), key=lambda kv: -sum(kv[1]))[:top]
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:top]
    return dict(
        wall_ms=wall_ms, device_ms=dev_ms, launches=launches,
        kernels=[(k[:60], len(v) / n, sum(v) / n) for k, v in kernels],
        host=[(e.key, e.count / n, e.self_cpu_time_total / 1e3 / n)
              for e in host])


def kernel_bound(feats, cnt, n_chan, n_aux, pairs):
    """Least time (ms) for the composite's work on this input, and which
    limit sets it: each used feature row of each valid slot read once, the
    output written once; per evaluated (pixel, splat) pair 26 + 2(C+A) fp32
    operations (see csrc/composite_fwd.cu)."""
    nv = n_chan + n_aux
    n_valid = int(cnt.sum())
    T = feats.shape[1]
    bytes_ = 4 * ((6 + nv) * n_valid + T + T * (nv + 2) * 256)
    ops = pairs * (26 + 2 * nv)
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card only")
        return 2

    from instag_torch import kernels
    from instag_torch.bench_utils import (synthetic_camera,
                                          synthetic_motion_params,
                                          synthetic_state)
    from instag_torch.device import resolve_device
    from instag_torch.ops.composite import composite_fwd, composite_fwd_plain
    from instag_torch.ops.rasterize import (RasterizeConfig, prepare,
                                            sh_colors, tile_features)
    from instag_torch.render import _masked_features
    from instag_torch.synthesize import (SynthesisModel, make_synthesis_fn,
                                         synthesize_frame)

    # ---- 1. device ------------------------------------------------------
    dev = resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(f"device: {name} (count {torch.cuda.device_count()}); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    built = kernels.build(["composite_fwd"])
    log(f"build: {time.perf_counter() - t0:.1f} s wall; per source "
        f"{ {k: round(v, 1) for k, v in built.items()} } (0 entries: cached)")
    with open(kernels.library_path("composite_fwd") + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

    # ---- model at full width ------------------------------------------------
    cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256)
    nets = synthetic_motion_params(device=dev)
    face = synthetic_state(30000, 32768, seed=0, scale=0.004, device=dev)
    mouth = synthetic_state(10000, 16384, seed=1, spread=0.05, scale=0.004,
                            device=dev)
    cam = synthetic_camera(SIZE, device=dev)
    model = SynthesisModel(face, mouth, nets["face_umf"], nets["mouth_umf"],
                           nets["face_pmf"], nets["mouth_pmf"])
    exp = nets["exp"]
    torso = torch.zeros((3, SIZE, SIZE), device=dev)
    auds = torch.from_numpy(np.random.default_rng(3).normal(
        size=(FRAMES, 8, 29, 16)).astype(np.float32)).to(dev)

    # ---- 3. kernel against its plain version on a real projection -----------
    with torch.no_grad():
        prep = prepare(cfg, face.params.xyz, face.get_scaling(),
                       face.get_rotation(), cam.view_transform,
                       cam.full_proj_transform, cam.camera_center,
                       cam.tanfovx, cam.tanfovy, active=face.alive)
        colors = sh_colors(face.params.xyz, cam.camera_center,
                           _masked_features(face), face.max_sh_degree)
        opac = face.get_opacity().reshape(-1)
        aux = torch.rand((face.capacity, 4), device=dev,
                         generator=torch.Generator(dev).manual_seed(7))
        cases = {}
        for n_chan, n_aux in [(8, 0), (3, 4)]:
            feats, cnt = tile_features(
                prep.px, prep.py, prep.proj, opac, colors,
                torch.ones_like(opac), prep.ids, prep.valid,
                light=n_chan == 3, aux_colors=aux if n_aux else None)
            out = composite_fwd(feats, cnt, cfg.tiles_x, n_chan, n_aux)
            ref, pairs = composite_fwd_plain(feats, cnt, cfg.tiles_x, n_chan,
                                             n_aux, count_pairs=True)
            torch.cuda.synchronize()
            err = (out - ref).abs().amax(dim=(0, 2)).tolist()
            worst = max(err)
            log(f"kernel C={n_chan} A={n_aux} F={feats.shape[0]} "
                f"T={feats.shape[1]} K={feats.shape[2]}: sum cnt "
                f"{int(cnt.sum())}, busy tiles {int((cnt > 0).sum())}, "
                f"pairs {pairs}; max |kernel - plain| per row "
                f"{[f'{e:.2e}' for e in err]}")
            if not worst <= ATOL:
                raise AssertionError(f"kernel disagrees with its plain "
                                     f"version: {worst} > {ATOL}")
            cases[(n_chan, n_aux)] = (feats, cnt, pairs, worst)

    # ---- 4. the serving path at full width ----------------------------------
    synth = make_synthesis_fn(cfg, personalized=True, device=dev)
    composite_fwd.launches = 0
    frames = [synth(model, cam, auds[i], exp, torso) for i in range(FRAMES)]
    torch.cuda.synchronize()
    launches = composite_fwd.launches
    for img in frames:
        assert img.dtype == torch.uint8 and img.shape == (SIZE, SIZE, 3)
    if launches != 2 * FRAMES:
        raise AssertionError(f"composite kernel launched {launches} times "
                             f"for {FRAMES} frames, expected {2 * FRAMES}")
    moved = int((frames[0].int() - frames[1].int()).abs().max())
    log(f"serving path: {FRAMES} frames uint8 {tuple(frames[0].shape)}, "
        f"composite launches {launches}, frame means "
        f"{[round(float(f.float().mean()), 3) for f in frames]}, "
        f"max |frame 0 - frame 1| {moved} (audio moves the mouth)")
    with torch.inference_mode():
        img_k = synthesize_frame(cfg, model, cam, auds[0], exp, torso,
                                 personalized=True)
        plain_cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256,
                                    backend="plain")
        img_p = synthesize_frame(plain_cfg, model, cam, auds[0], exp, torso,
                                 personalized=True)
    if not torch.isfinite(img_k).all():
        raise AssertionError("non-finite frame")
    frame_err = float((img_k - img_p).abs().max())
    covered = float(img_k.abs().sum(0).gt(0).float().mean())
    log(f"frame 0 kernel vs plain composite: max |diff| {frame_err:.2e} "
        f"(atol {ATOL}); non-black pixels {covered:.3f}")
    if not frame_err <= ATOL:
        raise AssertionError(f"frame disagrees with the plain composite: "
                             f"{frame_err}")

    # ---- 5. times --------------------------------------------------------------
    times = []
    for i in range(FRAMES * 4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        synth(model, cam, auds[i % FRAMES], exp, torso)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    frame_ms = statistics.median(times[FRAMES:])
    log(f"[{card}] frame: median {frame_ms:.3f} ms "
        f"({1e3 / frame_ms:.1f} FPS) over {len(times) - FRAMES} frames, "
        f"host clock around synchronize")

    feats, cnt, pairs, err_main = cases[(8, 0)]
    k_ms = cuda_ms(lambda: composite_fwd(feats, cnt, cfg.tiles_x, 8, 0))
    p_ms = cuda_ms(lambda: composite_fwd_plain(feats, cnt, cfg.tiles_x, 8, 0),
                   reps=2, rounds=5, warmup=1)
    bound_ms, bound_by = kernel_bound(feats, cnt, 8, 0, pairs)
    log(f"[{card}] composite_fwd C=8 A=0 T=1024 K=256: kernel {k_ms:.4f} ms, "
        f"plain {p_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"kernel at {bound_ms / k_ms:.1%} of bound")
    f34, c34, pairs34, err34 = cases[(3, 4)]
    k34 = cuda_ms(lambda: composite_fwd(f34, c34, cfg.tiles_x, 3, 4))
    log(f"[{card}] composite_fwd C=3 A=4: kernel {k34:.4f} ms")

    # ---- 6. where a frame's time goes ---------------------------------------
    prof = profile_frames(lambda: synth(model, cam, auds[1], exp, torso))
    log(f"[{card}] profiled frame: {prof['wall_ms']:.3f} ms wall under the "
        f"profiler, {prof['device_ms']:.3f} ms of device kernels "
        f"({prof['device_ms'] / prof['wall_ms']:.1%} busy), "
        f"{prof['launches']:.0f} kernel launches")
    for kname, count, ms in prof["kernels"]:
        log(f"  device {ms:8.3f} ms {count:6.0f}x  {kname}")
    for op, count, ms in prof["host"]:
        log(f"  host   {ms:8.3f} ms {count:6.0f}x  {op}")

    log(json.dumps({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "instag_torch/csrc/composite_fwd.cu",
        "replaces": "instag_tpu/ops/pallas_composite.py:190",
        "launches": launches, "max_abs_err": max(err_main, err34),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
