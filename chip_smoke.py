"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA kernel of the serving and training paths, from
     instag_torch/csrc, one nvcc each, started together;
  3. kernels against their plain PyTorch versions on the card, on tile
     features from a real 512x512 projection of the synthetic face cloud:
     the forward composite, the backward composite (C=8 with A=2 and A=0,
     cotangents from a seed) and the tile -> splat scatter-add;
  4. the serving path at full width (512x512, K=256, face 30000/32768 and
     mouth 10000/16384 splats, deepspeech nets, 8 frames with rotating
     audio windows): finite uint8 [512, 512, 3] frames, the composite
     kernel launched exactly twice per frame, and one frame held against
     the same frame through the plain composite;
  5. times with CUDA events, each beside the card's name and power limit;
  6. one profiled frame: device-busy share, launches, heaviest kernels and
     host operations;
  7. the face adaptation step at full width (512x512, K=256, face
     30000/32768 at scale 0.004, deepspeech nets, 4 synthetic frames, the
     pre-LPIPS flags of the JAX package's bench): one step's gradients
     through the kernels against the same step through the plain autograd
     composite, then 12 steps with finite losses, one launch of each
     kernel per step and live densification statistics;
  8. the step's time (host clock around synchronize), each training
     kernel's CUDA-event time beside its bound, its plain version and, for
     the scatter, ``index_add_``; one profiled step.
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
STEPS = 12               # face steps on the training main path
ATOL = 1e-4
BWD_RTOL = 1e-3          # backward kernel vs plain: per element, on top of
BWD_ATOL_FRAC = 1e-4     # this fraction of the largest |plain| term
GRAD_RTOL = 2e-3         # kernel step vs plain-autograd step gradients, on
GRAD_ATOL_FRAC = 5e-4    # top of this fraction of each tensor's max |g|
SCATTER_TOL = 1e-5       # atomics: the order of the adds changes per run
WARMUP = 5
SOURCES = ["composite_fwd", "composite_bwd", "scatter_add"]


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps=20, rounds=10, warmup=WARMUP) -> float:
    """Median over ``rounds`` of the mean ms of one call in a run of ``reps``
    back-to-back calls, timed with CUDA events. Each run is queued behind a
    spin kernel of ~25 ms, so that the host has enqueued the calls before
    the card reaches them: a call whose host side (wrapper checks, ctypes,
    allocation) takes longer than its kernels is still timed by the card.
    A call that waits on the card itself is timed with its waits."""
    for _ in range(warmup):
        fn()
    per_call = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / reps)
    return statistics.median(per_call)


def profile_runs(run, n=3, top=8):
    """One trace of ``n`` runs (frames or steps): per-run wall ms (under
    the profiler), device-kernel ms and launches per run, and the heaviest
    kernels and host operations."""
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
        # a GPU user annotation (an optimizer's step range) is no kernel
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
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


def bound(bytes_, ops):
    """The least time (ms) for ``bytes_`` moved and ``ops`` fp32 operations
    on the card, and which of the two sets it."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bwd_bound(feats, cnt, n_chan, n_aux, pairs):
    """Least time (ms) for the backward composite on this input: the used
    feature rows of each valid slot and the cotangents of the busy tiles
    read once, dfeats [F, T, K] written once; per evaluated (pixel, splat)
    pair a forward recompute (26 + 2(C+A)) and the gradient terms
    (23 + 4C + 2A) in fp32 (see csrc/composite_bwd.cu). Also returns the
    parts: the bytes of the zero-fill of idle tiles' dfeats, and the
    bytes-only and operations-only times of the busy tiles."""
    nv = n_chan + n_aux
    F, T, K = feats.shape
    busy = int((cnt > 0).sum())
    busy_bytes = 4 * ((6 + nv) * int(cnt.sum()) + T + busy * (nv + 2) * 256
                      + F * busy * K)
    fill_bytes = 4 * F * (T - busy) * K
    ops = pairs * (49 + 6 * n_chan + 4 * n_aux)
    parts = dict(fill_mb=fill_bytes / 1e6, busy_mb=busy_bytes / 1e6,
                 busy_bytes_ms=bound(busy_bytes, 0)[0],
                 ops_ms=bound(0, ops)[0])
    return (*bound(busy_bytes + fill_bytes, ops), parts)


def scatter_bound(g, cnt, n):
    """Least time (ms) for the scatter-add: g and ids of the valid slots and
    cnt read once, acc [F, n] written once; one add per valid element."""
    F = g.shape[0]
    n_valid = int(cnt.sum())
    bytes_ = 4 * (F * n_valid + n_valid + cnt.numel() + F * n)
    return bound(bytes_, F * n_valid)


def kernel_bound(feats, cnt, n_chan, n_aux, pairs):
    """Least time (ms) for the composite's work on this input, and which
    limit sets it: each used feature row of each valid slot read once, the
    output written once; per evaluated (pixel, splat) pair 26 + 2(C+A) fp32
    operations (see csrc/composite_fwd.cu)."""
    nv = n_chan + n_aux
    n_valid = int(cnt.sum())
    T = feats.shape[1]
    bytes_ = 4 * ((6 + nv) * n_valid + T + T * (nv + 2) * 256)
    return bound(bytes_, pairs * (26 + 2 * nv))


def rel_err_rows(out, ref):
    """Per feature row, max |out - ref| over the row's max |ref|."""
    err = (out - ref).abs().flatten(1).amax(1)
    top = ref.abs().flatten(1).amax(1).clamp_min(1e-30)
    return (err / top).tolist()


def check_close(name, out, ref, rtol, atol_frac):
    """|out - ref| <= atol_frac max(1e-6, max|ref|) + rtol |ref| everywhere
    (the floor, as in tests/test_pallas_composite.py, keeps a tensor whose
    gradient is rounding noise, such as the rotations of isotropic splats,
    from setting its own scale); returns the worst ratio of the error to
    that allowance."""
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: non-finite values")
    allow = atol_frac * max(1e-6, float(ref.abs().max())) + rtol * ref.abs()
    worst = float(((out - ref).abs() / allow.clamp_min(1e-30)).max())
    if not worst <= 1.0:
        raise AssertionError(f"{name}: disagrees with its reference, "
                             f"{worst:.2f}x the tolerance")
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device; this script runs on the card only")
        return 2

    from instag_torch import kernels
    from instag_torch.bench_utils import (synthetic_camera,
                                          synthetic_frame_batch,
                                          synthetic_motion_params,
                                          synthetic_state)
    from instag_torch.config import OptimizationConfig
    from instag_torch.device import resolve_device
    from instag_torch.models.gaussians import PARAM_FIELDS, adam_init
    from instag_torch.ops.composite import (composite_bwd,
                                            composite_bwd_plain,
                                            composite_fwd,
                                            composite_fwd_plain)
    from instag_torch.ops.rasterize import (RasterizeConfig, prepare,
                                            sh_colors, tile_features)
    from instag_torch.ops.scatter import (scatter_add_tiles,
                                          scatter_add_tiles_plain)
    from instag_torch.train.face import (Flags, make_face_block,
                                         make_face_step)
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
    built = kernels.build(SOURCES)
    log(f"build: {time.perf_counter() - t0:.1f} s wall; per source "
        f"{ {k: round(v, 1) for k, v in built.items()} } (0 entries: cached)")
    for src in SOURCES:
        with open(kernels.library_path(src) + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"  ptxas {src}:", line.strip())

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

        # the backward at the training shape (C=8, A=2) and without aux,
        # then the scatter-add of the training shape's dfeats
        gen = torch.Generator(dev).manual_seed(11)
        bwd = {}
        for n_aux in (2, 0):
            feats, cnt = tile_features(
                prep.px, prep.py, prep.proj, opac, colors,
                torch.ones_like(opac), prep.ids, prep.valid,
                aux_colors=aux[:, :n_aux] if n_aux else None)
            g = torch.randn((feats.shape[1], 10 + n_aux, 256), device=dev,
                            generator=gen)
            d_k = composite_bwd(feats, cnt, g, cfg.tiles_x, 8, n_aux)
            d_p = composite_bwd_plain(feats, cnt, g, cfg.tiles_x, 8, n_aux)
            torch.cuda.synchronize()
            worst = check_close(f"composite_bwd C=8 A={n_aux}", d_k, d_p,
                                BWD_RTOL, BWD_ATOL_FRAC)
            _, pairs = composite_fwd_plain(feats, cnt, cfg.tiles_x, 8, n_aux,
                                           count_pairs=True)
            log(f"kernel composite_bwd C=8 A={n_aux} F={feats.shape[0]}: "
                f"max |kernel - plain| / row max per row "
                f"{[f'{e:.1e}' for e in rel_err_rows(d_k, d_p)]}; "
                f"{worst:.3f} of the tolerance")
            bwd[n_aux] = (feats, cnt, g, d_k, pairs,
                          float((d_k - d_p).abs().max()))
        feats, cnt, g, d_k, _, _ = bwd[2]
        ids = prep.ids.contiguous()
        n_splats = face.capacity
        acc_k = scatter_add_tiles(d_k, ids, cnt, n_splats)
        acc_p = scatter_add_tiles_plain(d_k, ids, cnt, n_splats)
        torch.cuda.synchronize()
        check_close("scatter_add", acc_k, acc_p, SCATTER_TOL, SCATTER_TOL)
        scatter_err = float((acc_k - acc_p).abs().max())
        log(f"kernel scatter_add F={d_k.shape[0]} N={n_splats} valid slots "
            f"{int(cnt.sum())}: max |kernel - plain| / row max per row "
            f"{[f'{e:.1e}' for e in rel_err_rows(acc_k, acc_p)]}")

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
    prof = profile_runs(lambda: synth(model, cam, auds[1], exp, torso))
    log(f"[{card}] profiled frame: {prof['wall_ms']:.3f} ms wall under the "
        f"profiler, {prof['device_ms']:.3f} ms of device kernels "
        f"({prof['device_ms'] / prof['wall_ms']:.1%} busy), "
        f"{prof['launches']:.0f} kernel launches")
    for kname, count, ms in prof["kernels"]:
        log(f"  device {ms:8.3f} ms {count:6.0f}x  {kname}")
    for op, count, ms in prof["host"]:
        log(f"  host   {ms:8.3f} ms {count:6.0f}x  {op}")

    # ---- 7. the face adaptation step at full width --------------------------
    tr_nets = synthetic_motion_params(seed=1, device=dev)
    tr_state = synthetic_state(30000, 32768, seed=0, scale=0.004, device=dev)
    batch = synthetic_frame_batch(SIZE, n_frames=4, device=dev)
    flags = Flags(align=1.0, use_regs=1.0, use_sapiens=0.0, use_depth=1.0,
                  hair_paint=0.0, use_lpips=0.0)
    oc = OptimizationConfig()
    nets = (tr_nets["face_umf"], tr_nets["face_pmf"])
    block = make_face_block(cfg, oc, *nets, 1.0, False, device=dev)
    kernel_step = make_face_step(cfg, oc, *nets, 1.0, False, device=dev)
    plain_step = make_face_step(
        RasterizeConfig(SIZE, SIZE, max_per_tile=256, backend="plain"), oc,
        *nets, 1.0, False, device=dev)

    def step_grads(step):
        loss, _, g_gauss, g_off = step.loss_and_grads(tr_state, batch, 0,
                                                      flags)
        grads = {f: getattr(g_gauss, f) for f in PARAM_FIELDS}
        grads["means2d_offset"] = g_off
        for net in nets:
            for n, p in net.named_parameters():
                grads[f"{type(net).__name__}.{n}"] = p.grad.clone()
        return float(loss), grads

    loss_k, grads_k = step_grads(kernel_step)
    loss_p, grads_p = step_grads(plain_step)
    torch.cuda.synchronize()
    worst = max(check_close(f"face-step gradient {n}", grads_k[n],
                            grads_p[n], GRAD_RTOL, GRAD_ATOL_FRAC)
                for n in grads_p)
    off_norm = float(grads_k["means2d_offset"].norm())
    log(f"face step, kernels vs plain autograd: loss {loss_k:.6f} vs "
        f"{loss_p:.6f}; {len(grads_p)} gradient tensors within "
        f"{worst:.3f} of the tolerance; |d means2d| {off_norm:.3e}")
    if not (off_norm > 0 and abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)):
        raise AssertionError("dead densification hook or loss mismatch")

    gopt = adam_init(tr_state.params)
    for fn in (composite_fwd, composite_bwd, scatter_add_tiles):
        fn.launches = 0
    idxs = [i % batch.num_frames for i in range(STEPS)]
    tr_state, gopt, losses = block(tr_state, gopt, batch, idxs,
                                   range(1, STEPS + 1), flags)
    torch.cuda.synchronize()
    train_launches = {fn.__name__: fn.launches for fn in
                      (composite_fwd, composite_bwd, scatter_add_tiles)}
    losses = losses.tolist()
    log(f"training path: {STEPS} face steps, losses "
        f"{[round(x, 5) for x in losses]}, kernel launches {train_launches}, "
        f"denom sum {float(tr_state.denom.sum()):.0f}, grad-accum sum "
        f"{float(tr_state.xyz_grad_accum.sum()):.3e}, alive "
        f"{int(tr_state.num_alive())}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    if any(v != STEPS for v in train_launches.values()):
        raise AssertionError(f"expected one launch of each kernel per step: "
                             f"{train_launches}")
    if not (float(tr_state.denom.sum()) > 0
            and float(tr_state.xyz_grad_accum.sum()) > 0):
        raise AssertionError("densification statistics did not accumulate")

    # ---- 8. training times --------------------------------------------------
    step_times = []
    for it in range(STEPS + 1, STEPS + 11):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr_state, gopt, _ = block(tr_state, gopt, batch,
                                  [it % batch.num_frames], [it], flags)
        torch.cuda.synchronize()
        step_times.append((time.perf_counter() - t) * 1e3)
    step_ms = statistics.median(step_times)
    log(f"[{card}] face step: median {step_ms:.3f} ms over "
        f"{len(step_times)} steps (min {min(step_times):.3f}, max "
        f"{max(step_times):.3f}), host clock around synchronize")

    feats, cnt, g, d_k, pairs_b, err_b2 = bwd[2]
    b_ms = cuda_ms(lambda: composite_bwd(feats, cnt, g, cfg.tiles_x, 8, 2))
    bp_ms = cuda_ms(lambda: composite_bwd_plain(feats, cnt, g, cfg.tiles_x,
                                                8, 2),
                    reps=2, rounds=5, warmup=1)
    b_bound, b_by, b_parts = bwd_bound(feats, cnt, 8, 2, pairs_b)
    log(f"[{card}] composite_bwd C=8 A=2 T=1024 K=256: kernel {b_ms:.4f} ms, "
        f"plain {bp_ms:.3f} ms, bound {b_bound:.4f} ms ({b_by}), kernel at "
        f"{b_bound / b_ms:.1%} of bound; no single PyTorch call computes it")
    log(f"  composite_bwd bound parts: zero-fill of idle tiles' dfeats "
        f"{b_parts['fill_mb']:.3f} MB; busy tiles {b_parts['busy_mb']:.3f} MB "
        f"({b_parts['busy_bytes_ms']:.5f} ms) against operations "
        f"{b_parts['ops_ms']:.5f} ms ({pairs_b} pairs)")
    s_ms = cuda_ms(lambda: scatter_add_tiles(d_k, ids, cnt, n_splats))
    sp_ms = cuda_ms(lambda: scatter_add_tiles_plain(d_k, ids, cnt, n_splats))
    valid = prep.valid
    vid, gv = ids[valid].long(), d_k[:, valid]
    lib_ms = cuda_ms(lambda: torch.zeros((d_k.shape[0], n_splats),
                                         device=dev).index_add_(1, vid, gv))
    s_bound, s_by = scatter_bound(d_k, cnt, n_splats)
    log(f"[{card}] scatter_add F=16 N=32768 valid {int(cnt.sum())}: kernel "
        f"{s_ms:.4f} ms, plain {sp_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, "
        f"bound {s_bound:.5f} ms ({s_by}), kernel at {s_bound / s_ms:.1%} "
        f"of bound")

    it_prof = iter(range(STEPS + 11, STEPS + 20))
    prof = profile_runs(lambda: block(tr_state, gopt, batch, [0],
                                      [next(it_prof)], flags))
    log(f"[{card}] profiled step: {prof['wall_ms']:.3f} ms wall under the "
        f"profiler, {prof['device_ms']:.3f} ms of device kernels "
        f"({prof['device_ms'] / prof['wall_ms']:.1%} busy; "
        f"{prof['device_ms'] / step_ms:.1%} of the unprofiled median step), "
        f"{prof['launches']:.0f} kernel launches")
    for kname, count, ms in prof["kernels"]:
        log(f"  device {ms:8.3f} ms {count:6.0f}x  {kname}")
    for op, count, ms in prof["host"]:
        log(f"  host   {ms:8.3f} ms {count:6.0f}x  {op}")

    log(json.dumps({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "instag_torch/csrc/composite_fwd.cu",
        "replaces": "instag_tpu/ops/pallas_composite.py:190",
        "launches": launches + train_launches["composite_fwd"],
        "launches_by_path": {"serving": launches,
                             "training": train_launches["composite_fwd"]},
        "max_abs_err": max(err_main, err34),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}, {
        "name": "composite_bwd", "route": "cuda",
        "source": "instag_torch/csrc/composite_bwd.cu",
        "replaces": "instag_tpu/ops/pallas_composite.py:260",
        "launches": train_launches["composite_bwd"],
        "max_abs_err": max(err_b2, bwd[0][5]),
        "ms": b_ms, "plain_ms": bp_ms, "bound_ms": b_bound,
        "bound_by": b_by, "library_ms": None}, {
        "name": "scatter_add", "route": "cuda",
        "source": "instag_torch/csrc/scatter_add.cu",
        "replaces": "instag_tpu/ops/pallas_scatter.py:53",
        "launches": train_launches["scatter_add_tiles"],
        "max_abs_err": scatter_err,
        "ms": s_ms, "plain_ms": sp_ms, "bound_ms": s_bound,
        "bound_by": s_by, "library_ms": lib_ms}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
