"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):
  1. device: the card's name, and its name and power limit from nvidia-smi;
  2. build: every CUDA kernel of the serving and training paths, from
     instag_torch/csrc, one nvcc each, started together; phases 16 and 17
     run while they compile (the JPEG codec built first), phase 17 before
     phase 16's training run, which waits for them, so those two phases
     come before 3;
  3. kernels against their plain PyTorch versions on the card, on tile
     features from a real 512x512 projection of the synthetic face cloud
     (36 busy tiles) and of a wide cloud that busies every tile: the
     forward composite (serving shape C=8, A=0 and training shape C=8,
     A=2 on both clouds; C=3, A=4 on the face), the backward composite
     (C=8 with A=2 and A=0, cotangents from a seed; two runs bitwise
     equal) and the tile -> splat scatter-add;
  4. the serving path at full width (512x512, K=256, face 30000/32768 and
     mouth 10000/16384 splats, deepspeech nets, 8 frames with rotating
     audio windows): finite uint8 [512, 512, 3] frames, the composite
     kernel launched exactly twice per frame, and one frame held against
     the same frame through the plain composite;
  5. times with CUDA events, each beside the card's name and power limit:
     the frame, and the forward composite at the serving shape on both
     clouds beside its bound and its plain version;
  6. one profiled frame: device-busy share, launches, heaviest kernels and
     host operations;
  7. the face adaptation step at full width (512x512, K=256, face
     30000/32768 at scale 0.004, deepspeech nets, 4 synthetic frames, the
     pre-LPIPS flags of the JAX package's bench): one step's gradients
     through the kernels against the same step through the plain autograd
     composite, then 12 steps with finite losses, one launch of each
     kernel per step and live densification statistics;
  8. the step's time (host clock around synchronize), each training
     kernel's CUDA-event time on both clouds beside its bound, its plain
     version and, for the scatter, ``index_add_``; one profiled step;
  9. the adaptation loop at full width (``train.face.train_face``: 512x512,
     K=256, ``ModelConfig()``'s 10000 initial splats in an adaptive
     capacity of 32768 under 160768, deepspeech nets, the 16-frame orbit
     batch, 1200 steps with densification at step 150, the opacity reset at
     150, the green/depth prune every 50 steps from 150 and the SH bump at
     1000): finite losses that fall, one launch of each kernel per step, a
     densification that changed the live count, a depth prune that removed
     splats, SH degree 1 at the end, a finite frame from the final state,
     and one ``densify_and_prune`` on the card equal to the same call on
     the CPU; its wall time and ms per step (host clock around
     synchronize), each event's time on the final state, the cloud's
     construction with its kNN, and the live count and capacity at each
     log point (the loop runs without LPIPS: its phase would start at step
     1, ``iterations - 2500`` being below 0);
 10. the mouth loop at full width (``train.mouth.train_mouth`` under phase
     9's face bundle: the same batch, schedule and warm step, 10000 initial
     mouth splats at SH degree 2, deepspeech nets): finite losses that
     fall, one launch of each kernel per step, a densification that changed
     the live count, SH at the full degree, a finite mouth render from the
     final state, and the softening of greenish splats on the card equal
     to the CPU on the final state; its ms per step, each event's time, and
     one profiled step;
 11. the fusion loop at full width (``train.fuse.train_fuse`` on the face
     and mouth bundles, 200 steps, LPIPS from step 101 with random
     features unless converted weights are present): the snug pack of both
     clouds, finite losses, two launches of each kernel per step, the
     frozen geometry bit-equal before and after, and a finite fused 512x512
     frame from the result through ``make_synthesis_fn``; ms per step
     before and after LPIPS starts, and one profiled fusion step without
     and one with LPIPS. Also one face step of phase 7's kind in the LPIPS
     phase: a finite loss and a non-zero LPIPS term;
 12. clip synthesis: the committed JPEG fixture decoded by nvJPEG against
     its libjpeg decode; a 512x512 scene (16 train, 16 val frames) written
     by ``data.synthetic.generate_scene`` on the card and read back by
     ``load_frames`` (PNGs, torso composites, masks and au.csv equal to
     what the writer held, JPEG frames above 40 dB); phase 11's result
     saved as a fuse bundle (reloaded bit-equal) with its cfg_args.json;
     ``python -m instag_torch.cli.synthesize_fuse --fast`` as a subprocess,
     its frames bit-equal to an in-process ``synthesize()`` and frame 0 to
     ``make_synthesis_fn``'s, two composite launches a frame; select_every
     4 and select_auto 4.0: within a level of the same mode through the
     plain composite, freshly selected frames bit-equal to the exact clip,
     above 40 dB against it; each mode's FPS with and without set-up, and
     the times of the scene read and the bundle round trip;
 13. the adaptation CLIs at full width (``ModelConfig()``, K=256, deepspeech
     nets) on phase 12's scene: ``python -m instag_torch.cli.adapt`` as a
     subprocess (40 face and 40 mouth steps, 40 fusion steps, the val
     clip with its variants and PLYs, ``metrics.json`` with finite PSNR
     and LPIPS and its ``lpips_real`` flag); in process, ``cli.train_face``
     for 50 steps, then ``--start_checkpoint`` to 100 in another run
     directory (its first log point past 50; the bundle's state, Adam
     state, nets and optimizer states restored and written again to the
     same bytes; the UMF's scheduler at count 50 and its rates at the
     schedule's value there; its first 20 losses within rtol 1e-3 of an
     in-process ``train_face(resume_bundle=...)``, which launches each
     kernel once a step), ``cli.train_mouth``, ``cli.train_fuse_con`` and
     ``cli.synthesize_fuse --fast`` on that run; every bundle's key paths
     equal to the JAX CLIs' (``tests/torch_fixtures/bundle_keys.json``);
     and 30 face steps with the frames streamed from pinned host memory
     against the same steps from the frames on the card. Each CLI's wall
     time and ms per step, and the kernels' launches on the CLI path.
 14. multi-identity pre-training at full width (``ModelConfig()``, K=256,
     deepspeech nets; 2 identities, each a 512x512 ``generate_scene`` of 16
     train frames with ``variation`` 0.3 and its own seed; 2000 initial
     face and 5000 mouth splats, as scripts/pretrain_con.sh starts them):
     ``train.pretrain.pretrain_face`` for 1050 steps an identity (100 of
     warm-up an identity, densification from 25 every 25, the green
     prune after each, SH bumps at 1000 and 2000, log points every 250),
     then ``pretrain_mouth`` under its result for 200 steps an identity:
     finite losses that fall, one launch of each kernel per step, a
     densification that changed the live count; one face motion step
     without its D-SSIM term (noise over the background-green windows)
     through the kernels against plain autograd, both fed one cotangent
     (the step loss's gradient of the rendered image through the plain
     composite, as phase 15's static check) so that the parameter,
     offset, UMF and PMF gradients are compared, the two losses compared
     apart, and the L1 residuals whose signs differ between the two
     renders counted; the other identity's PMF bit-unchanged by a step, the
     EMA update on the card equal to the CPU's; each branch's warm-up and motion step alone on the final
     states and one profiled motion step of each; ``python -m
     instag_torch.cli.pretrain --iterations 20`` as a subprocess, its
     bundles' key paths equal to the JAX CLIs'; and ``cli.train_face
     --pretrain_path`` on its EMA bundle for 25 steps in process, from a
     UMF bit-equal to the EMA.
 15. static training and reference import at full width: a hard synthetic
     identity (``data.synthetic_hard.generate_hard_scene``, 512x512, 16
     train + 4 val frames) written on the card and read back (PNGs, torso
     composites, masks, landmarks and au.csv equal to what the writer
     held, JPEG frames above 40 dB); ``python -m instag_torch.train.static
     --iterations 1200`` on it as a subprocess with ``ModelConfig()``'s
     widths (10000 initial splats, capacity 160768, K=256, SH 2) and
     ``OptimizationConfig``'s schedule (densification every 100 steps from
     600, the SH bump at 1000): exit 0, a falling loss, a train-view PSNR
     5 dB above the initial cloud's, a densification that changed the live
     count, SH degree 1, one launch of each kernel a step; the CLI in
     process for 20 steps, its ``point_cloud.ply`` reloaded equal to its
     final state; on the subprocess's final cloud: 50 steps alone (one
     launch of each kernel a step), one step's gradients through the
     kernels against plain autograd (both fed the step loss's cotangent of
     the image through the plain composite), a reference ``capture()``
     with named Adam groups through ``torch.save`` and ``convert_capture``
     on the card (its render bit-equal, its moments equal), densifications,
     one profiled step and the three kernels at this shape (C=8, A=0)
     against their plain versions, with times (the forward held to 1e-4
     at every pixel off the transmittance cut: the pixels whose plain-walk
     transmittance after a splat lies within 64 float32 ulps of 1e-4 are
     counted and logged, at most 64 allowed); the brute-force oracle
     (``ops.reference_splat``, bbox_sigma 4) against the kernel path at
     128x128 with 2000 splats at SH degree 1 under the JAX suite's bounds,
     ``cov3d_precomp`` against scales and rotations (1e-5); and the AVE
     mel encoder on the card against the CPU over a wav's crops (1e-4).
 16. the preprocessing chain on the card: a raw capture of the hard
     identity (``data.synthetic_hard.render_hard_video``, 512x512, 20 + 5
     frames at 2x supersampling: an MJPEG AVI, its WAV and the stub of
     what the learned extractors would give); ``python -m
     instag_torch.data_utils.process <video> --task -1 --synthetic_gt
     <stub>`` as a subprocess with each task's wall; the scene contract of
     tests/test_e2e_seam.py (``aud_ds.npy`` [25, 16, 29]); ``ori_imgs``
     against the stub's frames by PSNR; ``track_params.npz`` against the
     tracker on the CPU over the same landmarks; ``bc.jpg``, ``gt_imgs``
     and ``torso_imgs`` (the plate and every 5th frame) against tasks 5-6
     computed on the CPU from the card's decoded inputs (byte-equal JPEGs,
     pixel-equal PNGs) and, where PIL imports, from libjpeg's decode (24
     levels, 2.0 on average); task 2 with ``--asr ave`` on the card
     against the CPU (1e-4 of the output's scale); ``cli.train_face`` in
     process on the output at ``ModelConfig()``'s widths for 100 steps
     (finite, falling losses, one launch of each kernel a step), then one
     densification of its final state; and the streamed read of the train
     split (its frames bit-equal to the CLI's read on the card, the card's
     memory growing by no more than one decode chunk while the
     ``HostFrameStore`` is built). Times: the capture, each task, the
     process, the train step and the streamed read.
 17. the photometric 3DMM fit and the learned extractors: (a) 50 frames of
     ``face_model.synthetic_model()`` rendered by ``mesh_render`` on the
     card at 512x512 and written by nvJPEG with their landmarks;
     ``tracker.track_poses`` without and with the model (downscale 4, the
     JAX defaults' iterations (400, 600, 60, 40)): non-zero exp and light,
     a saved landmark error no worse than the PnP-only run's + 1e-3 px;
     each stage's wall, the fit's peak card memory, and one stage-C step's
     device ms and launches (two profiled fits, 1 and 2 stage-C steps);
     (b) ``fit_photometric`` at (20, 20, 4, 4) on 8 of those 128x128
     frames on the card and the CPU, each output within 1e-3 of its scale;
     (c) ``3DMM/3dmm_model.npz`` written into phase 16's scene and ``python
     -m instag_torch.data_utils.process --task 8`` as a subprocess: 25
     frames of non-zero id, exp and light; (d) random-weight FAN-4, BiSeNet
     and EasyPortrait FPN checkpoints (seed 0, the public key layouts)
     through ``INSTAG_FAN_WEIGHTS``, ``INSTAG_BISENET_WEIGHTS`` and
     ``INSTAG_EASYPORTRAIT_FPN``: ``process --task 4`` and ``--task 11`` on
     a copy of phase 16's 25 frames and ``--task 7`` on its first 8 (a
     random FAN tracks nothing, and its box grows ~3x a frame), every
     file's shape and dtype; each network's raw output on 2 frames against
     the CPU (1e-4 of scale); how many landmarks and pixels of the first 2
     frames agree with the CPU's; ms a frame of each network.
 18. the parallel modes (``instag_torch/parallel/``) at phase 7's width:
     (a) a ``--data_parallel 4`` face step on the card (``make_face_step(
     dp=4)``): its loss the mean of four single-frame steps' (rtol 1e-5),
     its Gaussian, UMF and PMF gradients their mean (phase 7's tolerance),
     its statistics their sum, 4 launches of each kernel; ms a step
     against 4x phase 8's; (b) ``cli.train_face --data_parallel 4`` in
     process on phase 16's scene for 24 steps: finite losses, a bundle
     with the manifest's keys, ms a step; (c) 2 ranks sharing the card
     over gloo (``parallel.launch.start``, under its own time limit):
     the dp=4 step at W=2 (2 frames a rank) within fp32 summation order of
     (a), replicas bit-identical; one identity-parallel face motion step
     on phase 14's two identities, each rank's loss equal to the serial
     step's, the UMF bit-identical, rank 0's ``save_bundle_multihost``
     read back; a ``rasterize_tensor_parallel`` 512x512 frame, forward and
     backward, its bands, radii and gradients against the single-card
     rasterize (``tests/test_tensor_parallel.py``'s tolerances); (d) one
     rank over NCCL (world size 1, a file rendezvous): the dp=4 loss
     bit-equal to (a)'s, gradients within fp32 summation order (the
     scatter adds by atomics).
 19. the workflow scripts, as a user runs them, started with phase 14 and
     read after phase 15: ``bash scripts/torch/e2e_from_video.sh <tmp> 20
     256 40`` (a 20-frame 256x256 capture, ``process --synthetic_gt``,
     ``cli.adapt`` with 40 steps a stage; exit 0, ``metrics.json`` with
     finite PSNR and LPIPS, the clip's frames file) and ``python
     scripts/torch/verify_drive.py`` (the fit's PSNR climb, the probes);
     each one's wall beside the card's name and power limit, and its
     processes' kernel launches (each kernel launched), recorded at their
     exit through a ``sitecustomize`` on their ``PYTHONPATH``.
Each phase's start is logged as ``[t=... s]``.
The line before last is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import concurrent.futures
import contextlib
import csv
import ctypes
import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
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
EDGE_MAX_SHARE = 0.01    # phase 15: at most 1 % of the pixels on the cut
FLIP_RTOL = 1e-3         # T_final apart by more: a splat more or fewer
FLIP_ULPS = 4            # phase 14: an L1 residual this close to 0 is a tie
WIDE_SPREAD = 0.8        # a cloud over the whole frame: every tile busy
WIDE_SCALE = 0.01        # (~140k valid slots; the face cloud busies 36)
WARMUP = 5
SOURCES = ["composite_fwd", "composite_bwd", "scatter_add"]
# phase 9: the adaptation loop
LOOP_FRAMES = 16
LOOP_OPT = dict(iterations=1200, densify_from_iter=100,
                densification_interval=50, opacity_reset_interval=150,
                position_lr_max_steps=1200)
LOOP_WARM_STEP = 300
LOOP_LOG_EVERY = 100
DENSIFY_TOL = 1e-6       # card vs CPU densify: rtol and atol on parameters
SOFTEN_TOL = 1e-6        # card vs CPU softening: rtol and atol on fields
FUSE_STEPS = 200         # phase 11; LPIPS from FUSE_STEPS // 2 + 1
# phase 12: clip synthesis
ROOT = os.path.dirname(os.path.abspath(__file__))
CLIP_TRAIN, CLIP_VAL = 16, 16
FIXTURE_JPEG = "tests/torch_fixtures/frame_512.jpg"
FIXTURE_NPZ = "tests/torch_fixtures/frame_512_libjpeg.npz"
JPEG_FIXTURE_MAX = 3     # levels: nvJPEG's IDCT against libjpeg's islow
JPEG_FIXTURE_MEAN = 0.01  # (measured 3 and 0.0028; see PERF.md)
JPEG_PSNR_MIN = 40.0     # dB, nvJPEG q95 frames against the writer's arrays
# dB, select_every 4 / select_auto 4.0 against exact over the clip: the
# reuse modes lose detail where splats crossed tiles since the selection
# (43.9 / 48.0 dB on phase 11's clouds, and the JAX reference the same on
# the CPU on that bundle and scene; see PERF.md); the floor catches a broken
# reuse path, the two checks beside it its correctness
REUSE_PSNR_MIN = 40.0
# phase 13: the adaptation CLIs
BUNDLE_KEYS = "tests/torch_fixtures/bundle_keys.json"
ADAPT_ITERS, ADAPT_FUSE_ITERS = 40, 40
RESUME_AT, RESUME_TO = 50, 100       # train_face, then resumed to RESUME_TO
CLI_MOUTH_ITERS, CLI_FUSE_ITERS = 50, 50
RESUME_COMPARE, RESUME_RTOL = 20, 1e-3   # losses: CLI vs in process
STREAM_STEPS, STREAM_RTOL = 30, 1e-3     # losses: streamed vs on the card
REPORT_RENDERS = 8 + 4   # forward launches of a val report: 8 val, 4 train
# phase 14: multi-identity pre-training (scripts/pretrain_con.sh's inits)
PRE_IDS = ["id_a", "id_b"]
PRE_FRAMES = 16
PRE_FACE_INIT, PRE_MOUTH_INIT = 2000, 5000
PRE_FACE_OPT = dict(iterations=1050, densify_from_iter=25,
                    densification_interval=25)
PRE_MOUTH_ITERS = 200
PRE_WARM_PER_ID = 100
PRE_LOG_EVERY = 250
PRE_CLI_ITERS = 20
PRE_ADAPT_STEPS = 25
EMA_TOL = 1e-6           # card vs CPU EMA update: rtol and atol
# phase 15: static training and reference import
STATIC_FRAMES, STATIC_VAL = 16, 4
STATIC_ITERS = 1200       # the CLI's run (OptimizationConfig's schedule)
STATIC_CLI_CHECK_ITERS = 20   # the in-process CLI run whose PLY is checked
STATIC_STEPS_ALONE = 50   # steps timed alone on the final cloud
STATIC_DENSIFY_TIMED = 3
STATIC_PSNR_GAIN = 5.0    # dB over the initial cloud's train-view PSNR
SCENE_WRITE_MAX_S = 60.0
ORACLE_SIZE, ORACLE_SPLATS = 128, 2000
# the JAX suite's oracle bounds (tests/test_rasterize.py)
ORACLE_ATOL = {"image": 2e-3, "alpha": 2e-3, "depth": 2e-2, "normal": 5e-3}
COV3D_ATOL = 1e-5
AVE_TOL = 1e-4           # AVE encoder, card vs CPU, of the output's scale
# phase 16: the preprocessing chain
SEAM_FRAMES, SEAM_VAL = 20, 5            # 25 frames: 1 s at 25 fps
SEAM_ITERS = 100                         # cli.train_face steps on the output
SEAM_PSNR_MIN = 35.0     # dB, ori_imgs against the stub's frames (two q95
                         # and one q98 generation of nvJPEG)
SEAM_POSE_TOL = 1e-5     # track_params, card vs CPU (float32 on disk)
SEAM_CHECK_EVERY = 5     # tasks 5-6 checked on every 5th frame
SEAM_LEVELS = (24, 2.0)  # max and mean |level| against libjpeg's route
                         # (two q95 encoders and two decoders; measured 16
                         # and 1.08 on gt_imgs, first set at 16 and 1.0)
# phase 17: the photometric 3DMM fit and the learned extractors
FIT_FRAMES = 50          # the synthetic model's sequence, 2 s at 25 fps
FIT_FOCAL = 1200.0       # a candidate of the tracker's focal search
FIT_ITERS = (400, 600, 60, 40)           # the JAX package's defaults
FIT_DOWNSCALE = 4
FIT_CHECK_ITERS = (20, 20, 4, 4)         # card against the CPU
FIT_CHECK_FRAMES = 8     # of the 128x128 inputs (the CPU's share of time)
FIT_RTOL = 1e-3          # each output, of its scale
NET_TOL = 1e-4           # each network's raw output, card vs CPU, of scale
NET_CPU_FRAMES = 2       # frames whose files are also made on the CPU
# task 7's frames: a random FAN tracks nothing, and the box cropped around
# its landmarks grows ~3x a frame (as the JAX tracker's), so its run is
# held to the first frames of the capture
FAN_TRACK_FRAMES = 8
PRE_BUNDLES = {"pretrain_face": "chkpnt_face_latest.pkl",
               "pretrain_ema_face": "chkpnt_ema_face_latest.pkl",
               "pretrain_identity_face": "id_a_face_latest.pkl",
               "pretrain_mouth": "chkpnt_mouth_latest.pkl",
               "pretrain_ema_mouth": "chkpnt_ema_mouth_latest.pkl"}


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
    ratio = (out - ref).abs() / allow.clamp_min(1e-30)
    worst = float(ratio.max())
    if not worst <= 1.0:
        at = np.unravel_index(int(ratio.argmax()), tuple(ratio.shape))
        raise AssertionError(
            f"{name}: disagrees with its reference, {worst:.2f}x the "
            f"tolerance at {tuple(int(i) for i in at)} (ours "
            f"{float(out[at]):.6e}, reference {float(ref[at]):.6e}, "
            f"max |reference| {float(ref.abs().max()):.6e}; "
            f"{int((ratio > 1).sum())} of {ratio.numel()} elements over)")
    return worst


def fwd_check(label, feats, cnt, tiles_x, n_chan, n_aux):
    """The forward composite against its plain version on one cloud's tile
    features; returns the pairs a front-to-back walk evaluates and the
    largest error."""
    from instag_torch.ops.composite import composite_fwd, composite_fwd_plain

    out = composite_fwd(feats, cnt, tiles_x, n_chan, n_aux)
    ref, pairs = composite_fwd_plain(feats, cnt, tiles_x, n_chan, n_aux,
                                     count_pairs=True)
    torch.cuda.synchronize()
    err = (out - ref).abs().amax(dim=(0, 2)).tolist()
    log(f"{label} kernel C={n_chan} A={n_aux} F={feats.shape[0]} "
        f"T={feats.shape[1]} K={feats.shape[2]}: sum cnt {int(cnt.sum())}, "
        f"busy tiles {int((cnt > 0).sum())}, pairs {pairs}; max |kernel - "
        f"plain| per row {[f'{e:.2e}' for e in err]}")
    if not max(err) <= ATOL:
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version: {max(err)} > {ATOL}")
    return pairs, max(err)


def transmittance_edge(feats, cnt, tiles_x):
    """[T, P] bool: the pixels where the kernel's walk and the plain walk
    could disagree on whether a splat contributes. Both sum the same
    log1p(-alpha) steps (the same float32 operations) and test exp(sum) >=
    1e-4 with the same exp; they differ only in the order of the sum (the
    kernel adds in slot order, the plain walk's cumsum as a scan). Each
    order's partial sums all lie between 0 and the prefix S_j, so each
    rounds n_j times (n_j the evaluated splats up to slot j) by at most
    half an ulp of S_j: the two prefixes lie within n_j ulp(S_j) of each
    other, and twice that allows a step's own last bit. A pixel is on the
    edge where some evaluated slot's plain S_j lies within that band (and
    2 ulp more for the exp) of ln(1e-4). Found from the plain walk's own
    sums, never from the error; a pixel off the edge takes the same
    splats on both walks (ROADMAP section 3)."""
    from instag_torch.ops.composite import T_MIN, _chunks
    cut = float(np.log(np.float32(T_MIN)))
    edge = torch.zeros((feats.shape[1], 256), dtype=torch.bool,
                       device=feats.device)
    for ch in _chunks(feats, cnt, tiles_x, 16):
        s = torch.cumsum(ch.log_t, dim=-1)
        n = torch.cumsum(ch.ok.to(torch.float32), dim=-1)
        _, e = torch.frexp(s)
        ulp = torch.ldexp(torch.ones_like(s), e - 24)      # ulp of |S_j|
        band = 2.0 * n * ulp + 2.0 * ulp
        edge[ch.t0:ch.t1] = (ch.ok & ((s - cut).abs() <= band)).any(-1)
    return edge


def training_kernel_checks(label, feats, cnt, g, ids, n_splats, tiles_x,
                           n_aux, edge_aware: bool = False):
    """The training shape's kernels (C=8) on one cloud's tile features:
    the forward, the backward twice (bitwise equal) and the scatter-add of
    its dfeats, each against its plain version. ``edge_aware`` (a trained
    cloud) holds the forward to ``ATOL`` at every pixel off the
    transmittance cut (``transmittance_edge``), requires at most
    ``EDGE_MAX_SHARE`` of the pixels on it, and requires every pixel whose
    two walks took different splats (T_final apart by ``FLIP_RTOL``) to
    lie on it."""
    from instag_torch.ops.composite import (composite_bwd,
                                            composite_bwd_plain,
                                            composite_fwd,
                                            composite_fwd_plain)
    from instag_torch.ops.scatter import (scatter_add_tiles,
                                          scatter_add_tiles_plain)

    out = composite_fwd(feats, cnt, tiles_x, 8, n_aux)
    ref, pairs = composite_fwd_plain(feats, cnt, tiles_x, 8, n_aux,
                                     count_pairs=True)
    d_k = composite_bwd(feats, cnt, g, tiles_x, 8, n_aux)
    d_again = composite_bwd(feats, cnt, g, tiles_x, 8, n_aux)
    d_p = composite_bwd_plain(feats, cnt, g, tiles_x, 8, n_aux)
    torch.cuda.synchronize()
    fwd_err = float((out - ref).abs().max())
    if edge_aware:
        edge = transmittance_edge(feats, cnt, tiles_x)
        n_edge, most = int(edge.sum()), int(EDGE_MAX_SHARE * edge.numel())
        pix_err = (out - ref).abs().amax(1)                  # [T, P]
        edge_err = float(pix_err[edge].max()) if n_edge else 0.0
        fwd_err = float(pix_err[~edge].max())
        t_k, t_p = out[:, 9], ref[:, 9]                      # T_final
        flips = (t_k - t_p).abs() > FLIP_RTOL * t_p
        log(f"{label} forward: {n_edge} of {edge.numel()} pixels on the "
            f"1e-4 transmittance cut (at most {most}), max |kernel - "
            f"plain| there {edge_err:.2e}; elsewhere {fwd_err:.2e} (ATOL "
            f"{ATOL}); {int(flips.sum())} pixels took a splat more or "
            f"fewer, {int((flips & ~edge).sum())} of them off the cut")
        if n_edge > most:
            raise AssertionError(f"{label}: {n_edge} pixels at the "
                                 f"transmittance cut > {most}")
        if bool((flips & ~edge).any()):
            raise AssertionError(f"{label}: a pixel off the transmittance "
                                 "cut took other splats than the plain walk")
    if not fwd_err <= ATOL:
        raise AssertionError(f"{label}: composite_fwd off by {fwd_err}")
    if not torch.equal(d_k, d_again):
        raise AssertionError(f"{label}: two backward runs differ")
    worst = check_close(f"{label} composite_bwd C=8 A={n_aux}", d_k, d_p,
                        BWD_RTOL, BWD_ATOL_FRAC)
    log(f"{label} kernel composite_bwd C=8 A={n_aux} F={feats.shape[0]} "
        f"busy tiles {int((cnt > 0).sum())}, sum cnt {int(cnt.sum())}, "
        f"pairs {pairs}: max |kernel - plain| / row max per row "
        f"{[f'{e:.1e}' for e in rel_err_rows(d_k, d_p)]}; {worst:.3f} of "
        f"the tolerance; two runs bitwise equal; forward max |kernel - "
        f"plain| {fwd_err:.2e}")
    case = dict(feats=feats, cnt=cnt, g=g, d_k=d_k, pairs=pairs,
                fwd_err=fwd_err, bwd_err=float((d_k - d_p).abs().max()))
    acc_k = scatter_add_tiles(d_k, ids, cnt, n_splats)
    acc_p = scatter_add_tiles_plain(d_k, ids, cnt, n_splats)
    torch.cuda.synchronize()
    check_close(f"{label} scatter_add", acc_k, acc_p, SCATTER_TOL,
                SCATTER_TOL)
    case["scatter_err"] = float((acc_k - acc_p).abs().max())
    log(f"{label} kernel scatter_add F={d_k.shape[0]} N={n_splats} "
        f"valid slots {int(cnt.sum())}: max |kernel - plain| / row max "
        f"per row {[f'{e:.1e}' for e in rel_err_rows(acc_k, acc_p)]}")
    return case


def time_training_kernels(label, card, case, ids, valid, n_splats, tiles_x,
                          n_aux=2):
    """CUDA-event times of the three kernels on one cloud's training-shape
    inputs (C=8, A=``n_aux``), each beside its bound, its plain version
    and, for the scatter, ``index_add_`` on the pre-masked columns."""
    from instag_torch.ops.composite import (composite_bwd,
                                            composite_bwd_plain,
                                            composite_fwd,
                                            composite_fwd_plain)
    from instag_torch.ops.scatter import (scatter_add_tiles,
                                          scatter_add_tiles_plain)

    feats, cnt, g, d_k, pairs = (case[k] for k in
                                 ("feats", "cnt", "g", "d_k", "pairs"))
    T, K = feats.shape[1:]
    res = {}
    f_ms = cuda_ms(lambda: composite_fwd(feats, cnt, tiles_x, 8, n_aux))
    fp_ms = cuda_ms(lambda: composite_fwd_plain(feats, cnt, tiles_x, 8,
                                                n_aux),
                    reps=2, rounds=5, warmup=1)
    f_bound, f_by = kernel_bound(feats, cnt, 8, n_aux, pairs)
    res["composite_fwd"] = dict(ms=f_ms, plain_ms=fp_ms, bound_ms=f_bound,
                                bound_by=f_by, library_ms=None,
                                max_abs_err=case["fwd_err"])
    log(f"[{card}] {label} composite_fwd C=8 A={n_aux} T={T} K={K}: kernel "
        f"{f_ms:.4f} ms, plain {fp_ms:.3f} ms, bound {f_bound:.4f} ms "
        f"({f_by}), kernel at {f_bound / f_ms:.1%} of bound")

    b_ms = cuda_ms(lambda: composite_bwd(feats, cnt, g, tiles_x, 8, n_aux))
    bp_ms = cuda_ms(lambda: composite_bwd_plain(feats, cnt, g, tiles_x, 8,
                                                n_aux),
                    reps=2, rounds=5, warmup=1)
    b_bound, b_by, b_parts = bwd_bound(feats, cnt, 8, n_aux, pairs)
    res["composite_bwd"] = dict(ms=b_ms, plain_ms=bp_ms, bound_ms=b_bound,
                                bound_by=b_by, library_ms=None,
                                max_abs_err=case["bwd_err"])
    log(f"[{card}] {label} composite_bwd C=8 A={n_aux} T={T} K={K}: kernel "
        f"{b_ms:.4f} ms, plain {bp_ms:.3f} ms, bound {b_bound:.4f} ms "
        f"({b_by}), kernel at {b_bound / b_ms:.1%} of bound; no single "
        f"PyTorch call computes it")
    log(f"  {label} composite_bwd bound parts: zero-fill of idle tiles' "
        f"dfeats {b_parts['fill_mb']:.3f} MB; busy tiles "
        f"{b_parts['busy_mb']:.3f} MB ({b_parts['busy_bytes_ms']:.5f} ms) "
        f"against operations {b_parts['ops_ms']:.5f} ms ({pairs} pairs)")

    s_ms = cuda_ms(lambda: scatter_add_tiles(d_k, ids, cnt, n_splats))
    sp_ms = cuda_ms(lambda: scatter_add_tiles_plain(d_k, ids, cnt, n_splats))
    vid, gv = ids[valid].long(), d_k[:, valid]
    lib_ms = cuda_ms(lambda: torch.zeros((d_k.shape[0], n_splats),
                                         device=d_k.device
                                         ).index_add_(1, vid, gv))
    s_bound, s_by = scatter_bound(d_k, cnt, n_splats)
    res["scatter_add"] = dict(ms=s_ms, plain_ms=sp_ms, bound_ms=s_bound,
                              bound_by=s_by, library_ms=lib_ms,
                              max_abs_err=case["scatter_err"])
    log(f"[{card}] {label} scatter_add F={d_k.shape[0]} N={n_splats} valid "
        f"{int(cnt.sum())}: kernel {s_ms:.4f} ms, plain {sp_ms:.4f} ms, "
        f"index_add_ {lib_ms:.4f} ms, bound {s_bound:.5f} ms ({s_by}), "
        f"kernel at {s_bound / s_ms:.1%} of bound")
    return res


def host_ms(fn, reps=5) -> float:
    """Median host-clock ms of ``fn()`` between two synchronizes."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def kernel_fns():
    """The three kernel wrappers, whose ``launches`` count their launches."""
    from instag_torch.ops.composite import composite_bwd, composite_fwd
    from instag_torch.ops.scatter import scatter_add_tiles
    return composite_fwd, composite_bwd, scatter_add_tiles


def adaptation_loop(card: str, dev: torch.device, size: int):
    """Phase 9: ``train_face`` at full width, its checks and its times.
    Returns each kernel's launches in the loop, the loop's result (the face
    bundle of phases 10 and 11), its batch, meta and nets."""
    from instag_torch.bench_utils import (orbit_frame_batch,
                                          synthetic_motion_params)
    from instag_torch.config import ModelConfig, OptimizationConfig
    from instag_torch.data.dataset import random_init_points
    from instag_torch.models import gaussians as G
    from instag_torch.ops.composite import composite_bwd, composite_fwd
    from instag_torch.ops.knn import mean_knn_dist2
    from instag_torch.ops.scatter import scatter_add_tiles
    from instag_torch.render import render_motion
    from instag_torch.train import face as F

    model_cfg = ModelConfig()
    oc = OptimizationConfig(**LOOP_OPT)
    batch, meta = orbit_frame_batch(size, LOOP_FRAMES, device=dev)
    nets = synthetic_motion_params(seed=2, device=dev)

    # count each event's live splats before and after (device tensors,
    # read after the loop, so the loop waits on nothing more than it does)
    events = {k: [] for k in ("densify", "reset", "prune", "pack_resize")}
    log_points = []

    def counted(kind, fn):
        def run(state, opt, *args, **kw):
            depth = (state.alive & (state.params.xyz[:, 2] < -0.07)).sum()
            out = fn(state, opt, *args, **kw)
            born = (out[0].alive[:state.capacity] & ~state.alive).sum()
            events[kind].append((state.num_alive(), out[0].num_alive(), born,
                                 depth))
            return out
        return run

    originals = {(G, "densify_and_prune"): "densify",
                 (G, "reset_opacity"): "reset",
                 (F, "_prune_green_and_depth"): "prune",
                 (G, "pack_resize"): "pack_resize"}
    saved = {key: getattr(*key) for key in originals}
    for (mod, name), kind in originals.items():
        setattr(mod, name, counted(kind, saved[mod, name]))
    fns = (composite_fwd, composite_bwd, scatter_add_tiles)
    try:
        for fn in fns:
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = F.train_face(
            model_cfg, oc, batch, meta, umf_net=nets["face_umf"],
            pmf_net=nets["face_pmf"], log_every=LOOP_LOG_EVERY,
            warm_step=LOOP_WARM_STEP, lpips_enabled=False, device=dev,
            eval_fn=lambda end, st, *_: log_points.append(
                (end, st.num_alive(), st.capacity)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {fn.__name__: fn.launches for fn in fns}
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    steps = oc.iterations
    state, gopt, losses = res["state"], res["gopt"], np.array(res["losses"])
    log(f"[{card}] adaptation loop: {steps} steps in {wall:.2f} s wall, "
        f"{wall * 1e3 / steps:.2f} ms per step (events and set-up "
        f"included; host clock around synchronize); kernel launches "
        f"{launches}")
    log("  live splats / capacity at each log point: " + ", ".join(
        f"{end}: {int(n)}/{cap}" for end, n, cap in log_points))
    counts = {k: [tuple(int(x) for x in c) for c in v]
              for k, v in events.items()}
    log(f"  events (live before, after, born, behind z = -0.07 before; "
        f"prunes that removed nothing left out): "
        + str({k: [c for c in v if k != "prune" or c[0] != c[1]]
               for k, v in counts.items()})
        + f"; {len(counts['prune'])} prunes")
    first, last = losses[:100].mean(), losses[-100:].mean()
    log(f"  loss: mean of the first 100 steps {first:.5f}, of the last 100 "
        f"{last:.5f}; active SH degree {state.active_sh_degree}, capacity "
        f"{state.capacity}, dropped children {state.dropped_children}")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError("non-finite or missing loop losses")
    if not last < first:
        raise AssertionError("the loop's loss did not fall")
    if any(v != steps for v in launches.values()):
        raise AssertionError(f"expected one launch of each kernel per step: "
                             f"{launches}")
    if not any(b != a for b, a, _, _ in counts["densify"]):
        raise AssertionError("no densification changed the live count")
    if not counts["reset"]:
        raise AssertionError("no opacity reset ran")
    if not sum(d for _, _, _, d in counts["prune"]) > 0:
        raise AssertionError("the depth prune removed no splat")
    if state.active_sh_degree != 1:
        raise AssertionError(f"active SH degree {state.active_sh_degree}")
    with torch.no_grad():
        frame = render_motion(res["cfg"], batch.camera(0), state,
                              umf=res["umf_net"], aud=batch.auds[0],
                              exp=batch.au_exp[0],
                              bg=torch.zeros(3, device=dev),
                              pmf=res["pmf_net"], align=1.0).out.image
    if not torch.isfinite(frame).all():
        raise AssertionError("non-finite frame from the final state")

    # one densification on the card against the same call on the CPU, at
    # the median gradient of the live splats, so that half of them grow
    noise = torch.randn((2, state.capacity, 3), device=dev,
                        generator=torch.Generator(dev).manual_seed(5))
    grads = state.xyz_grad_accum / state.denom.clamp_min(1)
    args = (float(grads[state.alive & (state.denom > 0)].median()), 0.1,
            res["extent"], 20.0, oc.percent_dense)
    g_state, g_opt = G.densify_and_prune(state, gopt, noise, *args)
    c_state, c_opt = G.densify_and_prune(state.to("cpu"), gopt.to("cpu"),
                                         noise.cpu(), *args)
    if not torch.equal(g_state.alive.cpu(), c_state.alive):
        raise AssertionError("densify: card and CPU alive masks differ")
    worst = 0.0
    for f in G.PARAM_FIELDS:
        a, b = getattr(g_state.params, f).cpu(), getattr(c_state.params, f)
        worst = max(worst, float(((a - b).abs() / (DENSIFY_TOL * (
            1 + b.abs()))).max()))
    if not worst <= 1.0:
        raise AssertionError(f"densify: card and CPU parameters differ, "
                             f"{worst:.2f}x the tolerance")
    born = int((c_state.alive & ~state.alive.cpu()).sum())
    if not born > 0:
        raise AssertionError("densify on the card vs the CPU made no child")
    log(f"  densify on the card vs the CPU, same draws, gradient threshold "
        f"{args[0]:.3e} (the live median): alive masks equal ({born} "
        f"children, {int(c_state.alive.sum())} live), parameters within "
        f"{worst:.3f} of rtol = atol = {DENSIFY_TOL}")

    # each event's time on the final state, and the cloud's construction
    xyz, cols = (torch.from_numpy(a).to(dev)
                 for a in random_init_points(model_cfg.init_num))
    start_cap = G.adaptive_start_capacity(model_cfg.init_num,
                                          model_cfg.resolve_capacity())
    ev_ms = {
        "densify_and_prune": host_ms(
            lambda: G.densify_and_prune(state, gopt, noise, *args)),
        "prune_green_and_depth": host_ms(
            lambda: F._prune_green_and_depth(state, gopt,
                                             batch.camera_center[0], True)),
        "reset_opacity": host_ms(lambda: G.reset_opacity(state, gopt)),
        "pack_resize (x2)": host_ms(
            lambda: G.pack_resize(state, gopt, 2 * state.capacity)),
        "log-point read": host_ms(lambda: torch.cat([
            state.num_alive().to(torch.float32)[None],
            F.tile_saturation(res["cfg"], state, batch, 0)[None],
            torch.zeros(LOOP_LOG_EVERY, device=dev)]).tolist()),
        f"mean_knn_dist2 ({len(xyz)} points)": host_ms(
            lambda: mean_knn_dist2(xyz)),
        f"create_from_points ({len(xyz)} into {start_cap})": host_ms(
            lambda: G.create_from_points(xyz, cols, start_cap, 1,
                                         res["extent"])),
    }
    log(f"[{card}] event times on the final state (capacity "
        f"{state.capacity}, {int(state.num_alive())} live; median of 5, "
        f"host clock around synchronize): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in ev_ms.items()))

    # the loop's step alone on the final state, to set the loop's ms per
    # step beside phase 8's step on the synthetic face
    step = F.make_face_step(res["cfg"], oc, res["umf_net"], res["pmf_net"],
                            res["extent"], False, dev,
                            total_iters=oc.iterations,
                            warm_step=LOOP_WARM_STEP)
    flags = F._step_flags(oc.iterations, LOOP_WARM_STEP,
                          oc.iterations - 2500, False, oc)
    carry = [state, gopt]

    def one_step():
        carry[0], carry[1], _ = step(carry[0], carry[1], batch, 0,
                                     oc.iterations, flags)

    step_ms = host_ms(one_step, reps=10)
    prof = profile_runs(one_step)
    log(f"[{card}] the loop's step alone on the final state: median "
        f"{step_ms:.3f} ms over 10 steps (host clock around synchronize); "
        f"profiled: {prof['wall_ms']:.3f} ms wall, {prof['device_ms']:.3f} "
        f"ms of device kernels, {prof['launches']:.0f} kernel launches")
    for kname, count, ms in prof["kernels"]:
        log(f"  device {ms:8.3f} ms {count:6.0f}x  {kname}")
    return launches, res, batch, meta, nets


def mouth_loop(card: str, dev: torch.device, face: dict, batch, meta,
               nets: dict):
    """Phase 10: ``train_mouth`` at full width under the face bundle
    ``face``, its checks and its times. Returns each kernel's launches in
    the loop and the loop's result (the mouth bundle of phase 11)."""
    from instag_torch.config import ModelConfig, OptimizationConfig
    from instag_torch.models import gaussians as G
    from instag_torch.render import render_motion_mouth
    from instag_torch.train import mouth as M
    from instag_torch.utils.sh import rgb2sh

    model_cfg = ModelConfig()
    oc = OptimizationConfig(**LOOP_OPT)
    events = {k: [] for k in ("densify", "reset", "soften", "pack_resize")}

    def counted(kind, fn):
        def run(state, *args, **kw):
            out = fn(state, *args, **kw)
            new = out[0] if isinstance(out, tuple) else out
            softened = ((new.params.scaling != state.params.scaling).any(-1)
                        .sum() if new.capacity == state.capacity else 0)
            events[kind].append((state.num_alive(), new.num_alive(),
                                 softened))
            return out
        return run

    originals = {(G, "densify_and_prune"): "densify",
                 (G, "reset_opacity"): "reset",
                 (M, "_soften_green"): "soften",
                 (G, "pack_resize"): "pack_resize"}
    saved = {key: getattr(*key) for key in originals}
    for (mod, name), kind in originals.items():
        setattr(mod, name, counted(kind, saved[mod, name]))
    fns = kernel_fns()
    try:
        for fn in fns:
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = M.train_mouth(model_cfg, oc, batch, meta, face,
                            umf_net=nets["mouth_umf"],
                            pmf_net=nets["mouth_pmf"],
                            log_every=LOOP_LOG_EVERY,
                            warm_step=LOOP_WARM_STEP, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {fn.__name__: fn.launches for fn in fns}
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    steps = oc.iterations
    state, gopt, losses = res["state"], res["gopt"], np.array(res["losses"])
    log(f"[{card}] mouth loop: {steps} steps in {wall:.2f} s wall, "
        f"{wall * 1e3 / steps:.2f} ms per step (events and set-up included; "
        f"host clock around synchronize); kernel launches {launches}")
    counts = {k: [tuple(int(x) for x in c) for c in v]
              for k, v in events.items()}
    log(f"  events (live before, after, rows softened): {counts}")
    first, last = losses[:100].mean(), losses[-100:].mean()
    log(f"  loss: mean of the first 100 steps {first:.5f}, of the last 100 "
        f"{last:.5f}; SH degree {state.active_sh_degree} of "
        f"{state.max_sh_degree}, capacity {state.capacity}, live "
        f"{int(state.num_alive())}, dropped children "
        f"{state.dropped_children}")
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError("non-finite or missing mouth losses")
    if not last < first:
        raise AssertionError("the mouth loop's loss did not fall")
    if any(v != steps for v in launches.values()):
        raise AssertionError(f"expected one launch of each kernel per mouth "
                             f"step: {launches}")
    if not any(b != a for b, a, _ in counts["densify"]):
        raise AssertionError("no mouth densification changed the live count")
    rest_k = (model_cfg.sh_degree + 1) ** 2 - 1
    if not (state.max_sh_degree == model_cfg.sh_degree
            and state.params.features_rest.shape[1] == rest_k
            and state.active_sh_degree == 1):
        raise AssertionError(f"mouth SH degree {state.active_sh_degree} of "
                             f"{state.max_sh_degree}")
    with torch.no_grad():
        frame = render_motion_mouth(
            res["cfg"], batch.camera(0), state, mouth_umf=res["umf_net"],
            face_state=face["state"], face_umf=face["umf_net"],
            aud=batch.auds[0], bg=torch.zeros(3, device=dev),
            pmf=res["pmf_net"], align=1.0, k=30).out
    if not torch.isfinite(frame.image).all():
        raise AssertionError("non-finite mouth frame")

    # the softening (no event before step 2000) on the card and the CPU, on
    # the final state and on a copy with every other live splat painted
    # green (the final state may hold no greenish splat)
    campos = batch.camera_center[0]
    live = torch.nonzero(state.alive).flatten()[::2]
    dc, rest = (state.params.features_dc.clone(),
                state.params.features_rest.clone())
    dc[live, 0] = rgb2sh(torch.tensor([0.2, 0.9, 0.1], device=dev))
    rest[live] = 0.0
    painted = state.replace(params=G.GaussianParams(**dict(
        vars(state.params), features_dc=dc, features_rest=rest)))
    softened = []
    for st in (state, painted):
        g_st = M._soften_green(st, campos)
        c_st = M._soften_green(st.to("cpu"), campos.cpu())
        g_rows = (g_st.params.scaling != st.params.scaling).any(-1).cpu()
        c_rows = (c_st.params.scaling != st.params.scaling.cpu()).any(-1)
        if not torch.equal(g_rows, c_rows):
            raise AssertionError("soften: card and CPU pick other splats")
        worst = 0.0
        for a, b in ((g_st.params.opacity, c_st.params.opacity),
                     (g_st.params.scaling, c_st.params.scaling),
                     (g_st.xyz_grad_accum, c_st.xyz_grad_accum)):
            worst = max(worst, float(((a.cpu() - b).abs()
                                      / (SOFTEN_TOL * (1 + b.abs()))).max()))
        if not worst <= 1.0:
            raise AssertionError(f"soften: card and CPU differ, {worst:.2f}x "
                                 f"the tolerance")
        softened.append((int(c_rows.sum()), worst))
    if not softened[1][0] >= len(live):
        raise AssertionError(f"soften missed painted splats: {softened}")
    log(f"  soften on the card vs the CPU: the same splats softened on the "
        f"final state ({softened[0][0]}) and with {len(live)} live splats "
        f"painted green ({softened[1][0]}), fields within "
        f"{max(w for _, w in softened):.3f} of rtol = atol = {SOFTEN_TOL}; "
        f"final mouth frame finite, alpha max {float(frame.alpha.max()):.3f}")

    noise = torch.randn((2, state.capacity, 3), device=dev,
                        generator=torch.Generator(dev).manual_seed(6))
    grads = state.xyz_grad_accum / state.denom.clamp_min(1)
    args = (float(grads[state.alive & (state.denom > 0)].median()), 0.1,
            res["extent"], 20.0, oc.percent_dense)
    ev_ms = {
        "densify_and_prune": host_ms(
            lambda: G.densify_and_prune(state, gopt, noise, *args)),
        "soften_green": host_ms(lambda: M._soften_green(state, campos)),
        "reset_opacity": host_ms(lambda: G.reset_opacity(state, gopt)),
        "pack_resize (x2)": host_ms(
            lambda: G.pack_resize(state, gopt, 2 * state.capacity)),
    }
    log(f"[{card}] mouth event times on the final state (capacity "
        f"{state.capacity}, {int(state.num_alive())} live; median of 5, "
        f"host clock around synchronize): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in ev_ms.items()))

    step = M.make_mouth_step(res["cfg"], oc, res["umf_net"], res["pmf_net"],
                             face["state"], face["umf_net"], res["extent"],
                             dev, total_iters=oc.iterations,
                             warm_step=LOOP_WARM_STEP)
    flags = M.MouthFlags(align=1.0, use_regs=1.0)
    carry = [state, gopt]

    def one_step():
        carry[0], carry[1], _ = step(carry[0], carry[1], batch, 0,
                                     oc.iterations, 30, flags)

    step_ms = host_ms(one_step, reps=10)
    prof = profile_runs(one_step)
    log(f"[{card}] the mouth step alone on the final state: median "
        f"{step_ms:.3f} ms over 10 steps (host clock around synchronize); "
        f"profiled: {prof['wall_ms']:.3f} ms wall, {prof['device_ms']:.3f} "
        f"ms of device kernels, {prof['launches']:.0f} kernel launches")
    for kname, count, ms in prof["kernels"]:
        log(f"  device {ms:8.3f} ms {count:6.0f}x  {kname}")
    return launches, res


def lpips_face_step(card: str, dev: torch.device):
    """Phase 11's face step of phase 7's kind in the LPIPS phase: the loss
    with and without the LPIPS model on the same state."""
    from instag_torch.bench_utils import (synthetic_frame_batch,
                                          synthetic_motion_params,
                                          synthetic_state)
    from instag_torch.config import OptimizationConfig
    from instag_torch.models.lpips import load_lpips_params
    from instag_torch.ops.rasterize import RasterizeConfig
    from instag_torch.train.face import Flags, face_patch_sizes, make_face_step

    cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256)
    tr_nets = synthetic_motion_params(seed=1, device=dev)
    st = synthetic_state(30000, 32768, seed=0, scale=0.004, device=dev)
    batch = synthetic_frame_batch(SIZE, n_frames=4, device=dev)
    flags = Flags(align=1.0, use_regs=1.0, use_sapiens=0.0, use_depth=1.0,
                  hair_paint=0.0, use_lpips=1.0)
    lpips, real = load_lpips_params(device=dev)
    nets = (tr_nets["face_umf"], tr_nets["face_pmf"])
    sizes = face_patch_sizes(SIZE, SIZE)
    with_lp = make_face_step(cfg, OptimizationConfig(), *nets, 1.0, False,
                             device=dev, lpips=lpips, lpips_patches=sizes,
                             lips_crop=96)
    without = make_face_step(cfg, OptimizationConfig(), *nets, 1.0, False,
                             device=dev)
    mid = len(sizes) // 2
    loss_lp = float(with_lp.loss_and_grads(st, batch, 0, flags, mid)[0])
    loss = float(without.loss_and_grads(st, batch, 0, flags)[0])
    log(f"face step in the LPIPS phase (patch side {sizes[mid]}, LPIPS "
        f"{'converted weights' if real else 'RANDOM FEATURES (real=False)'}"
        f"): loss {loss_lp:.6f}, without the LPIPS term {loss:.6f}, LPIPS "
        f"term {loss_lp - loss:.3e}")
    if not (np.isfinite(loss_lp) and loss_lp - loss > 0):
        raise AssertionError("the LPIPS phase added no finite term")


def fuse_loop(card: str, dev: torch.device, face: dict, mouth: dict,
              batch):
    """Phase 11: ``train_fuse`` at full width on the face and mouth
    bundles, its checks and its times. Returns each kernel's launches in
    the loop and the loop's result (the fuse bundle of phase 12)."""
    from instag_torch.config import ModelConfig, OptimizationConfig
    from instag_torch.models import gaussians as G
    from instag_torch.models.lpips import load_lpips_params
    from instag_torch.ops.rasterize import RasterizeConfig
    from instag_torch.synthesize import SynthesisModel, make_synthesis_fn
    from instag_torch.train import fuse as FU

    # the card is synchronized before each block's first step and after its
    # last (steps 1, 100, 101 and 200), not in between
    marks = {}
    make_step = FU.make_fuse_step

    def timed_step(*args, **kw):
        step = make_step(*args, **kw)

        def run(*a):
            it = a[6]
            if it % 100 == 1:
                torch.cuda.synchronize()
                marks[it] = time.perf_counter()
            out = step(*a)
            if it % 100 == 0:
                torch.cuda.synchronize()
                marks[-it] = time.perf_counter()
            return out
        return run

    frozen = {"face": ("xyz", "scaling", "rotation"),
              "mouth": ("xyz", "scaling", "rotation", "opacity")}
    bundles = {"face": face, "mouth": mouth}
    before = {b: {f: getattr(bundles[b]["state"].params, f)[
        bundles[b]["state"].alive].clone() for f in frozen[b]}
        for b in frozen}
    caps = {b: (bundles[b]["state"].capacity,
                int(bundles[b]["state"].num_alive())) for b in frozen}
    real = load_lpips_params(device=dev)[1]
    log(f"fusion LPIPS: {'converted AlexNet weights' if real else 'RANDOM FEATURES (real=False): no converted weights present'}")
    oc = OptimizationConfig(iterations=FUSE_STEPS)
    fns = kernel_fns()
    FU.make_fuse_step = timed_step
    try:
        for fn in fns:
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = FU.train_fuse(ModelConfig(), oc, batch, face, mouth,
                            log_every=LOOP_LOG_EVERY, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {fn.__name__: fn.launches for fn in fns}
    finally:
        FU.make_fuse_step = make_step
    losses = np.array(res["losses"])
    after = {b: res[f"{b}_state"] for b in frozen}
    block_step_ms = [(marks[-e] - marks[e - 99]) * 1e3 / 100
                     for e in range(100, FUSE_STEPS + 1, 100)]
    log(f"[{card}] fusion loop: {FUSE_STEPS} steps in {wall:.2f} s wall, "
        f"{wall * 1e3 / FUSE_STEPS:.2f} ms per step (set-up included; host "
        f"clock around synchronize); per block of 100 steps "
        f"{[round(x, 3) for x in block_step_ms]} ms a step (LPIPS from step "
        f"{FUSE_STEPS // 2 + 1}); kernel launches {launches}")
    log("  snug pack (capacity, live before -> capacity after): " + ", ".join(
        f"{b} {caps[b][0]}, {caps[b][1]} -> {after[b].capacity}"
        for b in frozen))
    log(f"  loss: steps 1-100 mean {losses[:100].mean():.5f}, steps 101-200 "
        f"mean {losses[100:].mean():.5f}; first {losses[0]:.5f}, last "
        f"{losses[-1]:.5f}")
    if len(losses) != FUSE_STEPS or not np.isfinite(losses).all():
        raise AssertionError("non-finite or missing fusion losses")
    if any(v != 2 * FUSE_STEPS for v in launches.values()):
        raise AssertionError(f"expected two launches of each kernel per "
                             f"fusion step: {launches}")
    for b in frozen:
        st = after[b]
        want = 2 ** (2 * max(caps[b][1], 1) - 1).bit_length()
        if st.capacity != min(max(want, 2048), caps[b][0]):
            raise AssertionError(f"{b}: capacity {st.capacity} after the pack")
        for f in frozen[b]:
            if not torch.equal(getattr(st.params, f)[st.alive],
                               before[b][f]):
                raise AssertionError(f"fusion moved the frozen {b} {f}")
    log("  frozen geometry bit-equal before and after: "
        + ", ".join(f"{b} {'/'.join(frozen[b])}" for b in frozen))

    # one step without and one with LPIPS on the final states, profiled
    lpips = load_lpips_params(device=dev)[0]
    step = FU.make_fuse_step(res["cfg"], oc, res["face_umf_net"],
                             res["mouth_umf_net"], res["face_pmf_net"],
                             res["mouth_pmf_net"], 1.0, dev, lpips,
                             FU.fuse_patch_sizes(SIZE, SIZE))
    for use_lpips in (0.0, 1.0):
        prof = profile_runs(lambda: step(
            after["face"], G.adam_init(after["face"].params),
            after["mouth"], G.adam_init(after["mouth"].params), batch, 0,
            FUSE_STEPS, 0, use_lpips))
        log(f"[{card}] profiled fusion step, LPIPS {'on' if use_lpips else 'off'}"
            f" (patch side 32): {prof['wall_ms']:.3f} ms wall, "
            f"{prof['device_ms']:.3f} ms of device kernels "
            f"({prof['device_ms'] / prof['wall_ms']:.1%} busy), "
            f"{prof['launches']:.0f} kernel launches")
        for kname, count, ms in prof["kernels"][:5]:
            log(f"  device {ms:8.3f} ms {count:6.0f}x  {kname}")

    cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256)
    model = SynthesisModel(res["face_state"], res["mouth_state"],
                           res["face_umf_net"], res["mouth_umf_net"],
                           res["face_pmf_net"], res["mouth_pmf_net"])
    img = make_synthesis_fn(cfg, device=dev)(
        model, batch.camera(0), batch.auds[0], batch.au_exp[0],
        batch.bg_image(0))
    torch.cuda.synchronize()
    if not (img.dtype == torch.uint8 and img.shape == (SIZE, SIZE, 3)):
        raise AssertionError(f"fused frame {img.dtype} {tuple(img.shape)}")
    gt = batch.image[0].to(torch.float32)
    log(f"  fused frame from the result: uint8 {tuple(img.shape)}, mean "
        f"{float(img.float().mean()):.3f}, mean |frame - GT| "
        f"{float((img.float() - gt).abs().mean()):.3f} (of 255)")
    return launches, res


def _tree_equal(a, b, path="") -> None:
    """Raise unless two bundle trees hold the same keys, types, dtypes and
    bits."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or sorted(a) != sorted(b):
            raise AssertionError(f"bundle {path}: keys differ")
        for k in a:
            _tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, np.ndarray):
        if not (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b)):
            raise AssertionError(f"bundle {path}: array differs")
    elif type(a) is not type(b) or a != b:
        raise AssertionError(f"bundle {path}: {a!r} != {b!r}")


def _psnr(a, b) -> float:
    err = (np.asarray(a, np.float64) - np.asarray(b, np.float64)) / 255.0
    return float(-10.0 * np.log10(np.mean(err ** 2) + 1e-12))


def _luma(img) -> np.ndarray:
    img = np.asarray(img, np.float64)
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def jpeg_fixture_check(card: str, dev: torch.device) -> dict:
    """Phase 12, step 2: the committed fixture decoded by nvJPEG against
    its committed libjpeg (PIL) decode."""
    from instag_torch.data import image_io

    with open(os.path.join(ROOT, FIXTURE_JPEG), "rb") as f:
        blob = f.read()
    ref = np.load(os.path.join(ROOT, FIXTURE_NPZ))["image"].astype(np.int32)
    out = image_io.decode_jpegs([blob], dev)[0].cpu().numpy().astype(np.int32)
    d = np.abs(out - ref)
    dy = np.abs(_luma(out) - _luma(ref))
    res = dict(max=int(d.max()), mean=float(d.mean()),
               share_over_2=float((d > 2).mean()), luma_max=float(dy.max()),
               luma_mean=float(dy.mean()))
    log(f"nvJPEG vs libjpeg on {FIXTURE_JPEG} (512x512, 4:2:0, q95): RGB "
        f"max {res['max']}, mean {res['mean']:.4f}, share of values off by "
        f"more than 2 levels {res['share_over_2']:.4%}; luma (BT.601 of "
        f"RGB) max {res['luma_max']:.3f}, mean {res['luma_mean']:.4f}")
    if not (res["max"] <= JPEG_FIXTURE_MAX
            and res["mean"] <= JPEG_FIXTURE_MEAN):
        raise AssertionError(f"nvJPEG decode disagrees with libjpeg: {res}")
    return res


def _clip(cfg, model, batch, dev, select_every=1, select_auto=0.0):
    """A clip through the chunk functions of ``synthesize`` with ``cfg``
    (no warm-up, no timing): uint8 [F, H, W, 3] on the host."""
    from instag_torch.synthesize import (DISPATCH_CHUNK,
                                         make_synthesis_chunk_auto_fn,
                                         make_synthesis_chunk_fn)

    nf = batch.num_frames
    chunks = np.minimum(np.arange(-(-nf // DISPATCH_CHUNK) * DISPATCH_CHUNK),
                        nf - 1).reshape(-1, DISPATCH_CHUNK)
    imgs = []
    if select_auto > 0:
        boot, step = make_synthesis_chunk_auto_fn(cfg, thresh_px=select_auto,
                                                  device=dev)
        out, carry = boot(model, batch, chunks[0])
        imgs.append(out)
        for ch in chunks[1:]:
            out, carry = step(model, batch, ch, carry)
            imgs.append(out)
    else:
        fn = make_synthesis_chunk_fn(cfg, select_every=select_every,
                                     device=dev)
        imgs = [fn(model, batch, ch) for ch in chunks]
    return torch.cat(imgs)[:nf].cpu().numpy()


@contextlib.contextmanager
def _held_writes(module, held: dict):
    """Record, by path, every image ``module`` writes through its
    ``write_png`` and ``write_jpeg`` as the writer holds it."""
    write_png, write_jpeg = module.write_png, module.write_jpeg

    def rec_png(path, img):
        held[path] = np.array(img)
        write_png(path, img)

    def rec_jpeg(path, img, **kw):
        held[path] = img.cpu().numpy()
        write_jpeg(path, img, **kw)

    module.write_png, module.write_jpeg = rec_png, rec_jpeg
    try:
        yield held
    finally:
        module.write_png, module.write_jpeg = write_png, write_jpeg


def scene_readback(dev: torch.device, scene: str, held: dict):
    """Both splits of a written scene read on the card (the reader's memo
    cleared) and held to what the writer held: the torso PNGs, the torso
    composites over bc.jpg, the parsing masks and au.csv equal, the JPEG
    frames' PSNRs returned. Returns ({split: read s}, [PSNR dB])."""
    from instag_torch.data import dataset as D
    from instag_torch.data import image_io

    load_s, psnrs = {}, []
    for split in ("train", "val"):
        D._FRAMES_CACHE.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        records = D.load_frames(scene, split, device=dev)
        torch.cuda.synchronize()
        load_s[split] = time.perf_counter() - t
        bc = image_io.read_jpegs([os.path.join(scene, "bc.jpg")], dev)[0]
        for r in records:
            i = r.img_id
            if r.image.device.type != dev.type or r.bg.device != r.image.device:
                raise AssertionError("frames did not land on the card")
            psnrs.append(_psnr(r.image.cpu().numpy(), held[os.path.join(
                scene, "gt_imgs", f"{i}.jpg")]))
            torso = held[os.path.join(scene, "torso_imgs", f"{i}.png")]
            parsing = held[os.path.join(scene, "parsing", f"{i}.png")]
            got = image_io.read_png(os.path.join(scene, "torso_imgs",
                                                 f"{i}.png"), channels=4)
            if not np.array_equal(got, torso):
                raise AssertionError(f"torso PNG {i} read back differs")
            tt = torch.from_numpy(torso).to(dev).to(torch.float32)
            a = tt[..., 3:] / 255.0
            bg = (tt[..., :3] * a + bc * (1 - a)).to(torch.uint8)
            if not torch.equal(bg, r.bg):
                raise AssertionError(f"torso composite {i} differs")
            teeth = np.load(os.path.join(scene, "teeth_mask", f"{i}.npy"))
            p = parsing.astype(np.float32)
            face = ((p[..., 2] > 254) & (p[..., 0] == 0)
                    & (p[..., 1] == 0)) ^ teeth
            mouth = ((p[..., 0] == 100) & (p[..., 1] == 100)
                     & (p[..., 2] == 100)) | teeth
            if not (np.array_equal(face, r.face_mask)
                    and np.array_equal(mouth, r.mouth_mask)):
                raise AssertionError(f"parsing masks {i} differ")
        # au.csv: the float64 columns hold the float32 values written
        au = D.read_au_csv(os.path.join(scene, "au.csv"))
        with open(os.path.join(scene, "au.csv"), newline="") as f:
            rows = list(csv.reader(f))
        if not all(np.array_equal(au[c].astype(np.float32).astype(str),
                                  [r[j] for r in rows[1:]])
                   for j, c in enumerate(rows[0])):
            raise AssertionError("au.csv values do not round-trip")
    return load_s, psnrs


def clip_synthesis(card: str, dev: torch.device, fuse: dict) -> dict:
    """Phase 12: a 512x512 scene written and read on the card, phase 11's
    fusion result through a fuse bundle, and the clip through the
    ``synthesize_fuse`` CLI and in process in all three selection modes.
    Returns composite_fwd's launches in the exact in-process clip."""
    import tempfile

    from instag_torch.cli import synthesize_fuse as cli
    from instag_torch.config import ModelConfig, save_cfg
    from instag_torch.data import dataset as D
    from instag_torch.data import synthetic
    from instag_torch.io.checkpoints import (flax_params, load_bundle,
                                             save_bundle, state_to_dict)
    from instag_torch.ops.rasterize import RasterizeConfig
    from instag_torch.synthesize import (DISPATCH_CHUNK, make_synthesis_fn,
                                         synthesize)
    from instag_torch.train.common import build_frame_batch

    fixture = jpeg_fixture_check(card, dev)
    tmp = tempfile.TemporaryDirectory()
    scene = os.path.join(tmp.name, "scene")
    model_dir = os.path.join(tmp.name, "model")

    # the scene, its images recorded as the writer holds them
    held = {}
    with _held_writes(synthetic, held):
        torch.cuda.synchronize()
        t = time.perf_counter()
        synthetic.generate_scene(scene, n_frames=CLIP_TRAIN, size=SIZE,
                                 n_val=CLIP_VAL, device=dev)
        gen_s = time.perf_counter() - t
    log(f"[{card}] scene: {SIZE}x{SIZE}, {CLIP_TRAIN} train + {CLIP_VAL} val "
        f"frames written in {gen_s:.2f} s (JPEG by nvJPEG at q95, bc.jpg at "
        f"q75)")

    # every frame read back on the card
    load_s, psnrs = scene_readback(dev, scene, held)
    log(f"[{card}] load_frames: train {load_s['train']:.3f} s, val "
        f"{load_s['val']:.3f} s (memo cleared; nvJPEG decode, PNG in "
        f"numpy); PNGs, torso composites and masks equal what the writer "
        f"held; JPEG frames PSNR min {min(psnrs):.2f} dB, mean "
        f"{np.mean(psnrs):.2f} dB over {len(psnrs)} frames "
        f"(bound {JPEG_PSNR_MIN} dB)")
    if not min(psnrs) >= JPEG_PSNR_MIN:
        raise AssertionError(f"JPEG frames at {min(psnrs):.2f} dB")

    # phase 11's result as a fuse bundle, with the keys train_fuse_con writes
    bundle = dict(face_state=state_to_dict(fuse["face_state"]),
                  mouth_state=state_to_dict(fuse["mouth_state"]),
                  **{f"{k}_params": flax_params(fuse[f"{k}_net"])
                     for k in ("face_umf", "mouth_umf", "face_pmf",
                               "mouth_pmf")},
                  iteration=FUSE_STEPS)
    path = os.path.join(model_dir, "chkpnt_fuse_latest.pkl")
    t = time.perf_counter()
    save_bundle(path, bundle)
    loaded = load_bundle(path)
    round_s = time.perf_counter() - t
    _tree_equal(bundle, loaded)
    mc = ModelConfig(source_path=scene, model_path=model_dir,
                     max_per_tile=256)
    save_cfg(model_dir, mc)
    log(f"[{card}] fuse bundle: {os.path.getsize(path) / 1e6:.2f} MB, save "
        f"+ load {round_s:.3f} s, reloaded bit-equal")

    # the CLI, as a user runs it: with OpenCV where it imports (an mp4),
    # then with OpenCV hidden, which writes the lossless frame dump that
    # is compared bit for bit
    cmd = [sys.executable, "-m", "instag_torch.cli.synthesize_fuse", "-m",
           model_dir, "-s", scene, "--fast"]
    no_cv2 = os.path.join(tmp.name, "no_cv2")
    os.makedirs(no_cv2)
    with open(os.path.join(no_cv2, "cv2.py"), "w") as f:
        f.write("raise ImportError('hidden: the frames go to .frames.npz')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [no_cv2, ROOT, os.environ.get("PYTHONPATH", "")]))
    cli_s = {}
    started = {label: _Started(cmd, 900, **kw) for label, kw in (
        ("as found", {}), ("OpenCV hidden", {"env": env}))}
    for label, run in started.items():     # both at once
        proc, cli_s[label] = run.result()
        for line in (proc.stdout + proc.stderr).strip().splitlines()[-4:]:
            log(f"  cli ({label}) | {line}")
        if proc.returncode != 0:
            raise AssertionError(f"synthesize_fuse ({label}) exited "
                                 f"{proc.returncode}")
    mp4 = os.path.join(model_dir, "out.mp4")
    out_npz = mp4 + ".frames.npz"
    if not os.path.exists(out_npz):
        raise AssertionError("the CLI wrote no out.mp4.frames.npz")
    cli_frames = np.load(out_npz)["video"]
    mp4_note = "no OpenCV: the frame dump only"
    if os.path.exists(mp4):
        import cv2
        cap = cv2.VideoCapture(mp4)
        n_mp4 = 0
        while cap.read()[0]:
            n_mp4 += 1
        cap.release()
        if n_mp4 != CLIP_VAL:
            raise AssertionError(f"out.mp4 holds {n_mp4} frames")
        mp4_note = (f"out.mp4 through OpenCV {cv2.__version__}, "
                    f"{os.path.getsize(mp4) / 1e6:.2f} MB, {n_mp4} frames")

    # in process, the three modes
    model = cli.load_fuse_model(path, device=dev)
    fwd = kernel_fns()[0]
    runs = {}
    for mode, kw in (("exact", {}), ("select_every 4", {"select_every": 4}),
                     ("select_auto 4.0", {"select_auto": 4.0})):
        D._FRAMES_CACHE.clear()
        fwd.launches = 0
        out = io.StringIO()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(out):
            video, fps = synthesize(mc, model, split="val", out_path=None,
                                    device=dev, **kw)
        wall = time.perf_counter() - t
        runs[mode] = dict(kw=kw, video=video, fps=fps, wall=wall,
                          launches=fwd.launches, log=out.getvalue().strip())
    exact = runs["exact"]
    nf = exact["video"].shape[0]
    padded = -(-nf // DISPATCH_CHUNK) * DISPATCH_CHUNK
    if exact["video"].shape != (CLIP_VAL, SIZE, SIZE, 3):
        raise AssertionError(f"clip {exact['video'].shape}")
    if not np.array_equal(cli_frames, exact["video"]):
        diff = np.abs(cli_frames.astype(int) - exact["video"].astype(int))
        raise AssertionError(f"CLI frames differ from in-process synthesis: "
                             f"max {diff.max()}, share {(diff > 0).mean()}")
    # frame 0 through phase 5's per-frame function
    batch = build_frame_batch(D.load_frames(scene, "val", device=dev),
                              device=dev)
    cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256)
    frame0 = make_synthesis_fn(cfg, device=dev)(
        model, batch.camera(0), batch.auds[0], batch.au_exp[0],
        batch.bg_image(0)).cpu().numpy()
    if not np.array_equal(frame0, exact["video"][0]):
        raise AssertionError("frame 0 differs from make_synthesis_fn's")
    for mode, extra in (("exact", DISPATCH_CHUNK),
                        ("select_every 4", DISPATCH_CHUNK),
                        ("select_auto 4.0", 2 * DISPATCH_CHUNK)):
        want = 2 * (padded + extra)
        if runs[mode]["launches"] != want:
            raise AssertionError(f"{mode}: {runs[mode]['launches']} "
                                 f"composite launches, expected {want}")
    log(f"[{card}] CLI synthesize_fuse --fast: exit 0 twice, "
        f"{cli_frames.shape[0]} frames in {cli_s['as found']:.2f} s and "
        f"{cli_s['OpenCV hidden']:.2f} s wall (process start, bundle, scene "
        f"and kernel load included); {mp4_note}; the dump bit-equal to "
        f"in-process synthesize(); frame "
        f"0 bit-equal to make_synthesis_fn's; composite_fwd {exact['launches']} "
        f"launches for {padded} clip frames + a warm-up chunk of "
        f"{DISPATCH_CHUNK} (2 a frame)")
    plain_cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256,
                                backend="plain")
    for mode, r in runs.items():
        psnr = _psnr(r["video"], exact["video"])
        log(f"[{card}] clip {mode}: {r['fps']:.2f} FPS set-up excluded (the "
            f"timed run after the warm-up chunk), {nf / r['wall']:.2f} FPS "
            f"set-up included ({r['wall']:.2f} s wall: scene read, batch, "
            f"warm-up); PSNR against exact "
            f"{'-' if mode == 'exact' else f'{psnr:.2f} dB'}"
            f"{'; ' + r['log'] if r['log'] else ''}")
        if mode == "exact":
            continue
        # the reuse path through the kernels against the plain composite
        plain = _clip(plain_cfg, model, batch, dev, **r["kw"])
        diff = np.abs(plain.astype(int) - r["video"].astype(int))
        fresh = (range(0, nf, r["kw"]["select_every"])
                 if "select_every" in r["kw"] else [0])
        per_frame = [round(_psnr(v, e), 2) for v, e in zip(r["video"],
                                                            exact["video"])]
        log(f"  {mode}: against the same mode through the plain composite "
            f"max {diff.max()} level(s), {(diff > 0).mean():.2e} of values "
            f"differ; per-frame PSNR against exact {per_frame}")
        if not (diff.max() <= 1 and (diff > 0).mean() <= 1e-3):
            raise AssertionError(f"{mode}: kernel and plain clips differ")
        if not all(np.array_equal(r["video"][i], exact["video"][i])
                   for i in fresh):
            raise AssertionError(f"{mode}: a freshly selected frame "
                                 f"differs from the exact clip")
        if not psnr > REUSE_PSNR_MIN:
            raise AssertionError(f"{mode}: {psnr:.2f} dB against exact")
    return dict(launches=exact["launches"], fixture=fixture, tmp=tmp,
                scene=scene)


def _key_paths(tree, prefix=""):
    """A bundle's key paths, sorted; an empty map ends in '/' (as
    tests/test_torch_cli.py lists them)."""
    if isinstance(tree, dict):
        if not tree:
            return [prefix + "/"]
        return sorted(p for k, v in tree.items()
                      for p in _key_paths(v, f"{prefix}/{k}"))
    return [prefix]


_STARTED = []            # background CLIs, killed if the script ends first


@atexit.register
def _stop_started():
    for bg in _STARTED:
        if bg.proc.poll() is None:
            bg.proc.kill()
            bg.proc.wait()


class _Started:
    """A CLI run as a user runs it, started now and read later, so that
    it runs beside the phase's in-process work (the card is 6-25 % busy
    there; PERF.md section 5): ``result()`` waits for it under its time
    limit and returns (a ``CompletedProcess`` with its output, wall s from
    its start to its exit, however late it is read). Its output goes to
    files, not pipes, which a chatty run would fill."""

    def __init__(self, cmd, timeout, **kw):
        self.out = tempfile.TemporaryFile("w+")
        self.err = tempfile.TemporaryFile("w+")
        self.timeout, self.t = timeout, time.perf_counter()
        self.proc = subprocess.Popen(cmd, cwd=ROOT, stdout=self.out,
                                     stderr=self.err, text=True, **kw)
        self.ended = None        # when it exited, seen by a watcher thread
        threading.Thread(target=self._watch, daemon=True).start()
        _STARTED.append(self)

    def _watch(self):
        self.proc.wait()
        self.ended = time.perf_counter()

    def result(self):
        try:
            self.proc.wait(max(0.0, self.timeout
                               - (time.perf_counter() - self.t)))
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
            raise AssertionError(f"{self.proc.args[:3]} ran past "
                                 f"{self.timeout} s")
        while self.ended is None:          # the watcher's stamp, next
            time.sleep(0.01)
        wall = self.ended - self.t
        text = []
        for f in (self.out, self.err):
            f.seek(0)
            text.append(f.read())
            f.close()
        return subprocess.CompletedProcess(self.proc.args,
                                           self.proc.returncode,
                                           *text), wall


def _in_process(main, argv):
    """A CLI's ``main(argv)`` with its output kept: (result, output, wall
    s, each kernel's launches)."""
    fns = kernel_fns()
    for fn in fns:
        fn.launches = 0
    out = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = main(argv)
    torch.cuda.synchronize()
    return (res, out.getvalue(), time.perf_counter() - t,
            {fn.__name__: fn.launches for fn in fns})


def adaptation_clis(card: str, dev: torch.device, scene: str,
                    work: str) -> dict:
    """Phase 13: the adaptation CLIs on phase 12's scene, with resume and
    streaming. Returns each kernel's launches on the in-process CLI runs
    and the resumed run's in-process twin."""
    from instag_torch.cli import adapt, synthesize_fuse, train_face
    from instag_torch.cli import train_fuse_con, train_mouth
    from instag_torch.config import ModelConfig, OptimizationConfig
    from instag_torch.data.dataset import load_frames
    from instag_torch.io import msgpack
    from instag_torch.io.checkpoints import (gopt_from_dict, load_branch,
                                             load_bundle, restore_pmf_opt,
                                             restore_umf_opt, train_bundle,
                                             pmf_opt_to_dict,
                                             umf_opt_to_dict)
    from instag_torch.train import face as F
    from instag_torch.train.common import FrameMeta, frame_source
    from instag_torch.train.optim import (pmf_optimizer, umf_optimizer,
                                          umf_schedule)

    with open(os.path.join(ROOT, BUNDLE_KEYS)) as f:
        want_keys = json.load(f)
    device = ["--device", dev.type]
    total = {}

    def keys_check(run, which):
        got = _key_paths(load_bundle(os.path.join(
            run, f"chkpnt_{which}_latest.pkl")))
        if got != want_keys[which]:
            raise AssertionError(f"{run}: {which} bundle keys differ from "
                                 f"{BUNDLE_KEYS}")

    def tally(name, launches):
        total[name] = launches
        for k, v in launches.items():
            total.setdefault("all", {}).setdefault(k, 0)
            total["all"][k] += v

    # adapt as a user runs it
    run_a = os.path.join(work, "adapt")
    cmd = [sys.executable, "-m", "instag_torch.cli.adapt", "-s", scene, "-m",
           run_a, "--iterations", str(ADAPT_ITERS), "--fuse_iterations",
           str(ADAPT_FUSE_ITERS), *device]
    adapt_run = _Started(cmd, 900)      # read after the in-process runs

    def adapt_checks():
        proc, adapt_s = adapt_run.result()
        lines = (proc.stdout + proc.stderr).strip().splitlines()
        for line in (lines[-20:] if proc.returncode else
                     [x for x in lines if x.startswith("[adapt]")]):
            log(f"  adapt | {line}")
        if proc.returncode != 0:
            raise AssertionError(f"cli.adapt exited {proc.returncode}")
        for which in ("face", "mouth", "fuse"):
            keys_check(run_a, which)
        with open(os.path.join(run_a, "metrics.json")) as f:
            scores = json.load(f)
        if not (np.isfinite(scores["psnr"]) and np.isfinite(scores["lpips"])
                and isinstance(scores["lpips_real"], bool)):
            raise AssertionError(f"metrics.json: {scores}")
        if not any(os.path.exists(os.path.join(run_a, f"out.mp4{x}"))
                   for x in ("", ".frames.npz")):
            raise AssertionError("cli.adapt wrote no clip")
        log(f"[{card}] cli.adapt ({ADAPT_ITERS} face, {ADAPT_ITERS} mouth, "
            f"{ADAPT_FUSE_ITERS} fusion steps, the {CLIP_VAL}-frame val "
            f"clip with its variants and PLYs, metrics): exit 0 in "
            f"{adapt_s:.2f} s wall as a process, beside this phase's "
            f"in-process runs; metrics.json {scores}; bundle keys equal "
            f"{BUNDLE_KEYS}")

    # train_face, then resumed from its bundle in another run directory
    base = ["-s", scene, *device]
    run_b, run_c = os.path.join(work, "face"), os.path.join(work, "resumed")
    res_b, out_b, wall_b, n_b = _in_process(train_face.main, base + [
        "-m", run_b, "--iterations", str(RESUME_AT)])
    path_b = os.path.join(run_b, "chkpnt_face_latest.pkl")
    res_c, out_c, wall_c, n_c = _in_process(train_face.main, base + [
        "-m", run_c, "--iterations", str(RESUME_TO), "--start_checkpoint",
        path_b])
    for name, run, n, out, steps in (
            ("train_face", run_b, n_b, out_b, RESUME_AT),
            ("train_face --start_checkpoint", run_c, n_c, out_c,
             RESUME_TO - RESUME_AT)):
        keys_check(run, "face")
        reports = out.count("[face eval ")
        want = {"composite_fwd": steps + REPORT_RENDERS * reports,
                "composite_bwd": steps, "scatter_add_tiles": steps}
        if n != want:
            raise AssertionError(f"{name}: launches {n}, expected {want}")
        tally(name, n)
    wall = {"train_face": wall_b, "resume": wall_c}
    with open(os.path.join(run_c, "metrics.jsonl")) as f:
        logged = sorted({json.loads(x)["step"] for x in f})
    if not logged or logged[0] <= RESUME_AT:
        raise AssertionError(f"the resumed run logged at {logged}")

    # the restored objects write the bundle's bytes back
    with open(path_b, "rb") as f:
        raw = f.read()
    b = msgpack.unpackb(raw)
    branch = load_branch(path_b, "face", device=dev)
    umf_opt, umf_sched = umf_optimizer(branch["umf_net"],
                                       total_iters=RESUME_TO)
    pmf_opt = pmf_optimizer(branch["pmf_net"])
    restore_umf_opt(branch["umf_net"], umf_opt, umf_sched,
                    b["umf_opt_state"])
    restore_pmf_opt(branch["pmf_net"], pmf_opt, b["pmf_opt_state"])
    again = train_bundle(
        dict(branch, gopt=gopt_from_dict(b["gopt"], dev),
             umf_opt_state=umf_opt_to_dict(branch["umf_net"], umf_opt,
                                           umf_sched),
             pmf_opt_state=pmf_opt_to_dict(branch["pmf_net"], pmf_opt)),
        RESUME_AT, max_sh_degree=b["max_sh_degree"])
    if msgpack.packb(again) != raw:
        raise AssertionError("the restored face bundle writes other bytes")
    mult = umf_schedule(RESUME_TO)(RESUME_AT)
    if umf_sched.last_epoch != RESUME_AT or not all(
            abs(g["lr"] - base_lr * mult) <= 1e-12 * base_lr
            for g, base_lr in zip(umf_opt.param_groups, umf_sched.base_lrs)):
        raise AssertionError("the UMF schedule did not resume at its count")

    # the resumed run in process, from the same bundle
    mc = ModelConfig(source_path=scene)
    records = load_frames(scene, device=dev)
    meta = FrameMeta.from_records(records)
    fns = kernel_fns()
    for fn in fns:
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    twin = F.train_face(mc, OptimizationConfig(iterations=RESUME_TO),
                        frame_source(records, with_priors=True, device=dev),
                        meta, resume_bundle=load_bundle(path_b), device=dev)
    torch.cuda.synchronize()
    wall["in process"] = time.perf_counter() - t
    n_twin = {fn.__name__: fn.launches for fn in fns}
    steps = RESUME_TO - RESUME_AT
    if any(v != steps for v in n_twin.values()):
        raise AssertionError(f"resumed in process: launches {n_twin}")
    tally("train_face(resume_bundle=...)", n_twin)
    a = np.array(res_c["losses"][:RESUME_COMPARE])
    w = np.array(twin["losses"][:RESUME_COMPARE])
    rel = float(np.max(np.abs(a - w) / np.abs(w)))
    if not (len(a) == RESUME_COMPARE and rel <= RESUME_RTOL
            and np.isfinite(res_c["losses"]).all()):
        raise AssertionError(f"resumed CLI vs in process: rel {rel}")
    log(f"[{card}] cli.train_face (in process): {RESUME_AT} steps in "
        f"{wall_b:.2f} s ({wall_b * 1e3 / RESUME_AT:.2f} ms a step, scene "
        f"read, val reports and bundle included), resumed to {RESUME_TO} "
        f"in {wall_c:.2f} s ({wall_c * 1e3 / steps:.2f} ms a step); "
        f"in-process train_face(resume_bundle=...) {wall['in process']:.2f} "
        f"s ({wall['in process'] * 1e3 / steps:.2f} ms a step); first "
        f"log point {logged[0]}; restored bundle bit-equal on re-save; UMF "
        f"scheduler at count {umf_sched.last_epoch}, rates x{mult:g}; "
        f"first {RESUME_COMPARE} losses within rel {rel:.2e} of in "
        f"process (rtol {RESUME_RTOL}); launches {n_b}, {n_c}, {n_twin}")

    # mouth, fusion and the clip on the resumed run
    res_m, out_m, wall_m, n_m = _in_process(train_mouth.main, base + [
        "-m", run_c, "--iterations", str(CLI_MOUTH_ITERS)])
    keys_check(run_c, "mouth")
    if any(v != CLI_MOUTH_ITERS for v in n_m.values()):
        raise AssertionError(f"cli.train_mouth: launches {n_m}")
    tally("train_mouth", n_m)
    res_f, out_f, wall_f, n_f = _in_process(train_fuse_con.main, base + [
        "-m", run_c, "--iterations", str(CLI_FUSE_ITERS)])
    keys_check(run_c, "fuse")
    if any(v != 2 * CLI_FUSE_ITERS for v in n_f.values()):
        raise AssertionError(f"cli.train_fuse_con: launches {n_f}")
    tally("train_fuse_con", n_f)
    _, out_s, wall_s, n_s = _in_process(synthesize_fuse.main, [
        "-m", run_c, "--fast", *device])
    tally("synthesize_fuse", n_s)
    synth_line = out_s.strip().splitlines()[-1]
    for name, res in (("mouth", res_m), ("fuse", res_f)):
        if not np.isfinite(res["losses"]).all():
            raise AssertionError(f"non-finite {name} losses")
    log(f"[{card}] on the resumed run, in process: cli.train_mouth "
        f"{CLI_MOUTH_ITERS} steps in {wall_m:.2f} s ("
        f"{wall_m * 1e3 / CLI_MOUTH_ITERS:.2f} ms a step), "
        f"cli.train_fuse_con {CLI_FUSE_ITERS} steps in {wall_f:.2f} s ("
        f"{wall_f * 1e3 / CLI_FUSE_ITERS:.2f} ms a step), "
        f"cli.synthesize_fuse --fast {wall_s:.2f} s ({synth_line}); "
        f"launches {n_m}, {n_f}, {n_s}")

    # streaming: the frames in pinned host memory, uploaded a block at a time
    runs = {}
    for stream in (False, True):
        for fn in fns:
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            r = F.train_face(mc, OptimizationConfig(iterations=STREAM_STEPS),
                             frame_source(records, stream=stream,
                                          device=dev), meta,
                             lpips_enabled=False, device=dev)
        torch.cuda.synchronize()
        runs[stream] = (r["losses"], time.perf_counter() - t,
                        {fn.__name__: fn.launches for fn in fns})
    tally("train_face streamed", runs[True][2])
    a, w = np.array(runs[True][0]), np.array(runs[False][0])
    rel = float(np.max(np.abs(a - w) / np.abs(w)))
    if not (len(a) == STREAM_STEPS and rel <= STREAM_RTOL
            and all(v == STREAM_STEPS for v in runs[True][2].values())):
        raise AssertionError(f"streamed run: rel {rel}, {runs[True][2]}")
    log(f"[{card}] train_face, {STREAM_STEPS} steps without LPIPS: frames "
        f"streamed from pinned host memory {runs[True][1]:.2f} s, on the "
        f"card {runs[False][1]:.2f} s; losses within rel {rel:.2e} "
        f"(rtol {STREAM_RTOL}); launches {runs[True][2]}")
    adapt_checks()
    return total


def _count_calls(mod, name, calls):
    """Replace ``mod.name`` by a wrapper that records each call's live
    splats before and after; returns the original."""
    fn = getattr(mod, name)

    def run(state, *args, **kw):
        out = fn(state, *args, **kw)
        new = out[0] if isinstance(out, tuple) else out
        calls.append((state.num_alive(), new.num_alive()))
        return out
    setattr(mod, name, run)
    return fn


def _timed_loop(fn, *args, **kw):
    """``fn(*args, **kw)`` between two synchronizes, with the kernels'
    launch counts set to 0 just before: (result, wall s, launches)."""
    fns = kernel_fns()
    for f in fns:
        f.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn(*args, **kw)
    torch.cuda.synchronize()
    return (res, time.perf_counter() - t,
            {f.__name__: f.launches for f in fns})


def _loop_checks(tag, res, steps, launches):
    losses = np.array(res["losses"])
    first, last = losses[:100].mean(), losses[-100:].mean()
    log(f"  {tag} loss: mean of the first 100 steps {first:.5f}, of the "
        f"last 100 {last:.5f}; live splats / capacity "
        + ", ".join(f"{int(s.num_alive())}/{s.capacity}"
                    for s in res["states"])
        + "; active SH degrees "
        + str([s.active_sh_degree for s in res["states"]]))
    if len(losses) != steps or not np.isfinite(losses).all():
        raise AssertionError(f"{tag}: non-finite or missing losses")
    if not last < first:
        raise AssertionError(f"{tag}: the loss did not fall")
    if any(v != steps for v in launches.values()):
        raise AssertionError(f"{tag}: expected one launch of each kernel "
                             f"per step: {launches}")


def _pretrain_step_check(k_step, p_step, state, batch, flags, umf, pmf):
    """Phase 14's kernel against plain check of one pre-training face
    step of identity 0 on frame 1, as phase 15's static check: both paths
    are fed one cotangent, the step loss's gradient with respect to the
    rendered image taken through the plain composite, and their
    parameter, offset, UMF and PMF gradients are held to ``GRAD_RTOL`` /
    ``GRAD_ATOL_FRAC``. On a fitted cloud many L1 residuals lie within the
    two composites' rounding of 0, where L1's gradient may take either
    sign. Returns (each gradient's worst fraction of the tolerance, the
    kernel and plain losses, the residual counts: how many of the two
    renders' residuals differ in sign and how many of those are ties
    within ``FLIP_ULPS`` ulp of the pixel)."""
    from instag_torch.models import gaussians as G
    from instag_torch.train import pretrain as P

    real, seen = P.rgb_loss, {}

    def run(step, rgb):
        P.rgb_loss = rgb
        loss, _, g_gauss, g_off = step.loss_and_grads(state, 0, batch, 1,
                                                      flags)
        grads = {f: getattr(g_gauss, f) for f in G.PARAM_FIELDS}
        grads["means2d_offset"] = g_off
        for tag, net in (("umf", umf), ("pmf", pmf)):
            for n, p in net.named_parameters():
                grads[f"{tag}.{n}"] = p.grad.clone()
        return float(loss), grads

    def kept(tag):
        def rgb(img, gt, lam):
            seen[tag] = (img.detach(), gt)
            return real(img, gt, lam)
        return rgb

    try:
        loss_k = run(k_step, kept("kernel"))[0]
        loss_p = run(p_step, kept("plain"))[0]
        img_p, gt = seen["plain"]
        x = img_p.clone().requires_grad_(True)
        cot, = torch.autograd.grad(
            real(x, gt, p_step.opt_cfg.lambda_dssim), x)
        shared = lambda img, gt, lam: (img * cot).sum()   # noqa: E731
        g_k, g_p = run(k_step, shared)[1], run(p_step, shared)[1]
    finally:
        P.rgb_loss = real
    worst = {n: check_close(f"pre-training face step gradient {n}", g_k[n],
                            g_p[n], GRAD_RTOL, GRAD_ATOL_FRAC) for n in g_p}
    r_k, r_p = seen["kernel"][0] - gt, img_p - gt
    differ = torch.sign(r_k) != torch.sign(r_p)
    mag = torch.maximum(img_p.abs(), gt.abs())
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    near = differ & (torch.maximum(r_k.abs(), r_p.abs()) <= FLIP_ULPS * ulp)
    flips = dict(n=r_p.numel(), opposite=int(differ.sum()),
                 near=int(near.sum()))
    return worst, loss_k, loss_p, flips


def pretraining(card: str, dev: torch.device, keep: list,
                beside=None) -> tuple:
    """Phase 14: multi-identity pre-training at full width, its checks and
    its times. Returns each kernel's launches on the pre-training loops
    and on the in-process ``cli.train_face`` run from their EMA bundle."""
    import copy
    import tempfile

    from instag_torch.cli import train_face as train_face_cli
    from instag_torch.config import ModelConfig, OptimizationConfig
    from instag_torch.data.dataset import load_frames
    from instag_torch.data.synthetic import generate_scene
    from instag_torch.io.checkpoints import load_bundle
    from instag_torch.io.from_jax import load_motion_net
    from instag_torch.models import gaussians as G
    from instag_torch.models.motion import MotionNetwork
    from instag_torch.ops.rasterize import RasterizeConfig
    from instag_torch.train import pretrain as P
    from instag_torch.train.common import build_frame_batch
    from instag_torch.train.optim import ema_update

    with open(os.path.join(ROOT, BUNDLE_KEYS)) as f:
        want_keys = json.load(f)
    tmp = tempfile.TemporaryDirectory()
    root = os.path.join(tmp.name, "ids")
    t = time.perf_counter()
    for k, name in enumerate(PRE_IDS):
        generate_scene(os.path.join(root, name), n_frames=PRE_FRAMES,
                       size=SIZE, n_val=2, seed=20 + k, variation=0.3,
                       device=dev)
    log(f"[{card}] pre-training: {len(PRE_IDS)} identities of "
        f"{PRE_FRAMES} frames at {SIZE}x{SIZE} written in "
        f"{time.perf_counter() - t:.2f} s")

    # the face loop, counting the densifications and the green prunes
    mc = ModelConfig(source_path=root, init_num=PRE_FACE_INIT)
    oc = OptimizationConfig(**PRE_FACE_OPT)
    densify, prune = [], []
    saved = [(G, "densify_and_prune", _count_calls(G, "densify_and_prune",
                                                   densify)),
             (P, "_prune_green", _count_calls(P, "_prune_green", prune))]
    try:
        face, face_s, face_n = _timed_loop(
            P.pretrain_face, mc, oc, PRE_IDS, log_every=PRE_LOG_EVERY,
            warm_per_id=PRE_WARM_PER_ID, device=dev)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    face_steps = oc.iterations * len(PRE_IDS)
    log(f"[{card}] pretrain_face: {face_steps} steps ({PRE_WARM_PER_ID} "
        f"warm-up steps an identity) in {face_s:.2f} s wall, "
        f"{face_s * 1e3 / face_steps:.2f} ms per step (events and set-up "
        f"included; host clock around synchronize); kernel launches "
        f"{face_n}")
    counts = [(int(a), int(b)) for a, b in densify]
    pruned = [(int(a), int(b)) for a, b in prune]
    log(f"  densifications (live before, after) {counts}; green prunes "
        f"{pruned}")
    _loop_checks("pretrain_face", face, face_steps, face_n)
    if not (counts and pruned and any(b != a for a, b in counts)):
        raise AssertionError("no densification and green prune changed "
                             "the live count")
    if sum(s.active_sh_degree for s in face["states"]) != 2:
        raise AssertionError("expected the SH bumps at steps 1000 and 2000")

    # the mouth loop under the face result
    mcm = ModelConfig(source_path=root, init_num=PRE_MOUTH_INIT,
                      type="mouth")
    ocm = OptimizationConfig(iterations=PRE_MOUTH_ITERS)
    mouth, mouth_s, mouth_n = _timed_loop(
        P.pretrain_mouth, mcm, ocm, PRE_IDS, face, log_every=PRE_LOG_EVERY,
        warm_per_id=PRE_WARM_PER_ID, device=dev)
    mouth_steps = ocm.iterations * len(PRE_IDS)
    log(f"[{card}] pretrain_mouth: {mouth_steps} steps in {mouth_s:.2f} s "
        f"wall, {mouth_s * 1e3 / mouth_steps:.2f} ms per step; kernel "
        f"launches {mouth_n}")
    _loop_checks("pretrain_mouth", mouth, mouth_steps, mouth_n)
    loops = {k: face_n[k] + mouth_n[k] for k in face_n}

    # one face motion step on the final state of identity 0, through the
    # kernels against plain autograd, on copies of the nets. Both without
    # the D-SSIM term: the render and its painted target are background
    # green over most SSIM windows, where the SSIM's variance is float32
    # cancellation noise, so a 1e-7 difference between two composites
    # moves its gradient by many times the tolerance (ROADMAP.md §3).
    batch = build_frame_batch(load_frames(os.path.join(root, PRE_IDS[0]),
                                          "train", device=dev), device=dev)
    extent = face["states"][0].spatial_lr_scale
    umf = copy.deepcopy(face["umf_net"])
    pmfs = [copy.deepcopy(p) for p in face["pmf_nets"]]
    ema = copy.deepcopy(face["ema_net"])
    plain_cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256,
                                backend="plain")
    sched = (1, face_steps)
    l1_oc = OptimizationConfig(**PRE_FACE_OPT, lambda_dssim=0.0)
    k_l1, p_l1 = (P.make_pretrain_face_step(cfg, l1_oc, umf, pmfs, ema,
                                            extent, *sched, device=dev)
                  for cfg in (face["cfg"], plain_cfg))
    k_step = P.make_pretrain_face_step(face["cfg"], oc, umf, pmfs, ema,
                                       extent, *sched, device=dev)
    flags = P.PretrainFlags(use_regs=1.0, hair_paint=0.0)
    state, gopt = face["states"][0], face["gopts"][0]
    worst, loss_k, loss_p, flips = _pretrain_step_check(
        k_l1, p_l1, state, batch, flags, umf, pmfs[0])
    log(f"  face motion step without D-SSIM, kernels vs plain autograd: "
        f"loss {loss_k:.6f} vs {loss_p:.6f}; with one cotangent, "
        f"{len(worst)} gradient tensors within {max(worst.values()):.3f} "
        f"of the tolerance (worst {max(worst, key=worst.get)})")
    log(f"  L1 residuals of the two renders: {flips['opposite']} of "
        f"{flips['n']} differ in sign, {flips['near']} of them ties within "
        f"{FLIP_ULPS} ulp of the pixel")
    if not abs(loss_k - loss_p) <= 1e-4 * abs(loss_p):
        raise AssertionError("pre-training step: loss mismatch")
    other = copy.deepcopy(pmfs[1].state_dict())
    state, gopt, _ = k_step(state, gopt, 0, batch, 1, face_steps, flags)
    if not all(torch.equal(v, other[k])
               for k, v in pmfs[1].state_dict().items()):
        raise AssertionError("a step moved the other identity's PMF")

    # the EMA update on the card against the CPU
    e_card = copy.deepcopy(ema)
    ema_update(e_card, umf)
    e_cpu = copy.deepcopy(ema).cpu()
    ema_update(e_cpu, copy.deepcopy(umf).cpu())
    ema_err = max(float(((a.cpu() - b).abs() / (1 + b.abs())).max())
                  for a, b in zip(e_card.state_dict().values(),
                                  e_cpu.state_dict().values()))
    log(f"  EMA update on the card vs the CPU: within {ema_err:.2e} "
        f"(tolerance {EMA_TOL}); other identity's PMF bit-unchanged by a "
        f"step")
    if not ema_err <= EMA_TOL:
        raise AssertionError("EMA update: card and CPU differ")

    # each step alone on the final states, and one profiled motion step
    warm_f = P.make_warm_step(face["cfg"], oc, extent, False, dev)
    mbatch = build_frame_batch(load_frames(os.path.join(root, PRE_IDS[0]),
                                           "train", device=dev), device=dev)
    m_state, m_gopt = mouth["states"][0], mouth["gopts"][0]
    m_step = P.make_pretrain_mouth_step(
        mouth["cfg"], ocm, copy.deepcopy(mouth["umf_net"]),
        [copy.deepcopy(p) for p in mouth["pmf_nets"]],
        copy.deepcopy(mouth["ema_net"]), face["states"],
        copy.deepcopy(face["ema_net"]), extent, *sched, device=dev)
    warm_m = P.make_warm_step(mouth["cfg"], ocm, extent, True, dev)
    carry = {"face": [state, gopt], "mouth": [m_state, m_gopt]}

    def face_warm():
        carry["face"][:2] = warm_f(*carry["face"], batch, [1], [1])[:2]

    def face_motion():
        carry["face"][:2] = k_step(*carry["face"], 0, batch, 1, face_steps,
                                   flags)[:2]

    def mouth_warm():
        carry["mouth"][:2] = warm_m(*carry["mouth"], mbatch, [1], [1])[:2]

    def mouth_motion():
        carry["mouth"][:2] = m_step(*carry["mouth"], 0, 1, mbatch, 1,
                                    mouth_steps, flags)[:2]

    step_ms = {name: host_ms(fn, reps=10) for name, fn in (
        ("face warm-up", face_warm), ("face motion", face_motion),
        ("mouth warm-up", mouth_warm), ("mouth motion", mouth_motion))}
    log(f"[{card}] pre-training steps alone on the final states (median of "
        f"10, host clock around synchronize): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in step_ms.items()))
    for name, fn in (("face", face_motion), ("mouth", mouth_motion)):
        prof = profile_runs(fn)
        log(f"[{card}] profiled {name} motion step: {prof['wall_ms']:.3f} "
            f"ms wall under the profiler, {prof['device_ms']:.3f} ms of "
            f"device kernels ({prof['device_ms'] / prof['wall_ms']:.1%} "
            f"busy), {prof['launches']:.0f} kernel launches")
        for kname, count, ms in prof["kernels"]:
            log(f"  device {ms:8.3f} ms {count:6.0f}x  {kname}")

    # the chain's CLI as a user runs it, then train_face from its EMA
    run = os.path.join(tmp.name, "pretrain")
    cmd = [sys.executable, "-m", "instag_torch.cli.pretrain", "-s", root,
           "-m", run, "--iterations", str(PRE_CLI_ITERS), "--init_num",
           str(PRE_FACE_INIT), "--mouth_init_num", str(PRE_MOUTH_INIT),
           "--device", dev.type]
    cli = _Started(cmd, 600)
    beside = beside() if beside else None     # runs while the CLI does
    proc, cli_s = cli.result()
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    for line in (lines[-20:] if proc.returncode else
                 [x for x in lines if x.startswith("[pretrain]")]):
        log(f"  pretrain | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"cli.pretrain exited {proc.returncode}")
    for key, fname in PRE_BUNDLES.items():
        if _key_paths(load_bundle(os.path.join(run, fname))) \
                != want_keys[key]:
            raise AssertionError(f"{fname}: key paths differ from "
                                 f"{BUNDLE_KEYS}")
    log(f"[{card}] cli.pretrain ({PRE_CLI_ITERS} face and "
        f"{PRE_CLI_ITERS} mouth steps an identity): exit 0 in {cli_s:.2f} s "
        f"wall as a process (beside phase 15's scene and CLI); bundle keys "
        f"equal {BUNDLE_KEYS}")

    ema_path = os.path.join(run, "chkpnt_ema_face_latest.pkl")
    started = {}
    real = train_face_cli.train_face

    def train_face(*args, umf_net=None, **kw):
        started.update({k: v.clone() for k, v in
                        umf_net.state_dict().items()})
        return real(*args, umf_net=umf_net, **kw)

    train_face_cli.train_face = train_face
    try:
        res, _, tf_s, tf_n = _in_process(train_face_cli.main, [
            "-s", os.path.join(root, PRE_IDS[0]), "--iterations",
            str(PRE_ADAPT_STEPS), "--pretrain_path", ema_path,
            "--device", dev.type])
    finally:
        train_face_cli.train_face = real
    want = load_motion_net(MotionNetwork(),
                           load_bundle(ema_path)["ema_params"], dev)
    if not all(torch.equal(started[k], v)
               for k, v in want.state_dict().items()):
        raise AssertionError("train_face did not start from the EMA")
    if not (np.isfinite(res["losses"]).all()
            and all(v == PRE_ADAPT_STEPS for v in tf_n.values())):
        raise AssertionError(f"train_face from the EMA: {tf_n}")
    log(f"[{card}] cli.train_face --pretrain_path <EMA bundle>, "
        f"{PRE_ADAPT_STEPS} steps in process: {tf_s:.2f} s wall, its UMF "
        f"bit-equal to the EMA at the start, kernel launches {tf_n}")
    keep.append((tmp, root))       # phase 18 trains on these identities
    return {"pretraining": loops, "pretraining_train_face": tf_n}, beside


def _speech_wav(path: str, seconds: float = 2.0, sr: int = 16000) -> None:
    """A 16-bit wav of two formant-like tones under a syllable envelope,
    with noise from a seed."""
    from scipy.io import wavfile

    t = np.arange(int(seconds * sr)) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 4.0 * t) ** 2
    sig = env * (0.5 * np.sin(2 * np.pi * 220 * t)
                 + 0.3 * np.sin(2 * np.pi * 1250 * t))
    sig += 0.05 * np.random.default_rng(0).normal(size=t.shape)
    wavfile.write(path, sr, (0.9 * sig / np.abs(sig).max() * 32767
                             ).astype(np.int16))


def _oracle_scene(dev: torch.device):
    """ORACLE_SPLATS splats at SH degree 1 over most of a 128x128 frame,
    small enough that no tile holds more than K of them, and its camera.
    Their opacities stay below 0.35: the tiled path composites a splat
    only in the tiles its 3-sigma square touches (as the reference's
    rasterizer does), while the oracle sweeps its 4-sigma box, and above
    that opacity the alpha at 3 sigma, 0.0111 times the opacity, passes
    the 1/255 floor, so the two would differ at pixels between the two
    boxes."""
    from instag_torch.utils.graphics import projection_matrix, world_to_view

    rng = np.random.default_rng(5)
    n = ORACLE_SPLATS
    arrays = [
        rng.uniform(-1, 1, (n, 3)) * np.array([0.7, 0.7, 0.4]),   # means
        rng.uniform(0.05, 0.35, (n, 1)),                           # opacity
        0.01 + 0.02 * rng.uniform(size=(n, 3)),                    # scales
        rng.normal(size=(n, 4)),                                   # rotations
        0.3 * rng.normal(size=(n, 4, 3))]                          # SH
    w2c = world_to_view(np.eye(3), np.array([0.0, 0.0, 2.0]))
    proj = projection_matrix(0.01, 100.0, 0.7, 0.7)
    arrays += [w2c.T, (proj @ w2c).T, np.linalg.inv(w2c)[:3, 3]]
    return ([torch.from_numpy(np.asarray(a, np.float32)).to(dev)
             for a in arrays], float(np.tan(0.35)))


def static_scene(card: str, dev: torch.device) -> dict:
    """Phase 15's start: the hard synthetic identity written and read on
    the card, and ``python -m instag_torch.train.static`` on it started as
    a user runs it; ``static_training`` reads it. Returns the scene and
    the started CLI."""
    import tempfile

    from instag_torch.config import ModelConfig, OptimizationConfig
    from instag_torch.data import synthetic_hard

    mc, oc = ModelConfig(), OptimizationConfig(iterations=STATIC_ITERS)
    capacity = mc.resolve_capacity()
    tmp = tempfile.TemporaryDirectory()
    scene = os.path.join(tmp.name, "hard")

    # the scene, its images and landmarks recorded as the writer holds them
    held, lms = {}, []
    landmarks = synthetic_hard._landmarks

    def rec_landmarks(*args):
        lms.append(landmarks(*args))
        return lms[-1]

    synthetic_hard._landmarks = rec_landmarks
    try:
        with _held_writes(synthetic_hard, held):
            torch.cuda.synchronize()
            t = time.perf_counter()
            synthetic_hard.generate_hard_scene(
                scene, n_frames=STATIC_FRAMES, size=SIZE, n_val=STATIC_VAL,
                device=dev)
            write_s = time.perf_counter() - t
    finally:
        synthetic_hard._landmarks = landmarks
    load_s, psnrs = scene_readback(dev, scene, held)
    for i, want in enumerate(lms):
        got = np.loadtxt(os.path.join(scene, "ori_imgs", f"{i}.lms"))
        if not np.array_equal(got, [[float(f"{v:.2f}") for v in row]
                                    for row in want]):
            raise AssertionError(f"landmarks {i} differ from what the "
                                 "writer held")
    log(f"[{card}] hard scene: {SIZE}x{SIZE}, {STATIC_FRAMES} train + "
        f"{STATIC_VAL} val frames written in {write_s:.2f} s (ray-traced "
        f"on the host at 2x supersampling, JPEG by nvJPEG), read in "
        f"{load_s['train']:.3f} + {load_s['val']:.3f} s; PNGs, torso "
        f"composites, masks, landmarks and au.csv equal what the writer "
        f"held; JPEG frames PSNR min {min(psnrs):.2f} dB, mean "
        f"{np.mean(psnrs):.2f} dB (bound {JPEG_PSNR_MIN} dB)")
    if not min(psnrs) >= JPEG_PSNR_MIN:
        raise AssertionError(f"JPEG frames at {min(psnrs):.2f} dB")
    if write_s > SCENE_WRITE_MAX_S:
        log(f"  the hard scene took over {SCENE_WRITE_MAX_S} s to write")

    # the CLI as a user runs it, read by static_training
    run = os.path.join(tmp.name, "static")
    cmd = [sys.executable, "-m", "instag_torch.train.static",
           "--source_path", scene, "--model_path", run, "--iterations",
           str(STATIC_ITERS), "--device", dev.type]
    return dict(mc=mc, oc=oc, capacity=capacity, tmp=tmp, scene=scene,
                run=run, cli=_Started(cmd, 600))


def static_training(card: str, dev: torch.device, hard: dict) -> dict:
    """Phase 15: on ``static_scene``'s hard synthetic identity,
    ``python -m instag_torch.train.static`` at full width, the
    kernels against plain on its final cloud, the brute-force oracle and
    ``cov3d_precomp``, a reference checkpoint imported, and the AVE
    encoder. Returns each kernel's launches on the phase's main path (the
    CLI as a process and in process)."""
    import ast

    from instag_torch.data.audio import AudioWindows, load_wav
    from instag_torch.data.dataset import (load_frames, random_init_points,
                                           scene_extent)
    from instag_torch.io.checkpoints import (gopt_from_dict,
                                             load_gaussian_ply,
                                             state_from_dict)
    from instag_torch.io.reference_convert import convert_capture
    from instag_torch.models import gaussians as G
    from instag_torch.models.nets import AudioEncoder
    from instag_torch.ops.rasterize import (RasterizeConfig, prepare,
                                            rasterize, sh_colors,
                                            tile_features)
    from instag_torch.ops.reference_splat import splat_reference
    from instag_torch.render import _masked_features, render
    from instag_torch.train import static as S
    from instag_torch.train.common import (build_frame_batch,
                                           gaussian_backward, rgb_loss)
    from instag_torch.utils.general import quat_to_rotmat, safe_normalize

    mc, oc, capacity, tmp, scene, run = (hard[k] for k in (
        "mc", "oc", "capacity", "tmp", "scene", "run"))

    # the initial cloud's train-view PSNR, as the trainer starts it
    records = load_frames(scene, "train", device=dev)
    batch = build_frame_batch(records, device=dev)
    _, extent = scene_extent(records)
    cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=mc.max_per_tile)
    xyz, colors = random_init_points(mc.init_num)
    state0 = G.create_from_points(torch.from_numpy(xyz).to(dev),
                                  torch.from_numpy(colors).to(dev), capacity,
                                  mc.sh_degree, extent)
    psnr0 = S.train_view_psnr(cfg, state0, batch)

    # the CLI as a user runs it, started by static_scene
    proc, cli_s = hard["cli"].result()
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    for line in (lines[-20:] if proc.returncode else lines):
        log(f"  static | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"train.static exited {proc.returncode}")
    res = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    points = [int(x.split("points=")[1].split()[0]) for x in lines
              if x.startswith("[") and "points=" in x]
    log(f"[{card}] train.static {STATIC_ITERS} steps at {SIZE}x{SIZE}, "
        f"capacity {capacity}, K={mc.max_per_tile}: exit 0 in {cli_s:.2f} s "
        f"wall as a process (beside cli.pretrain); its loop "
        f"{res['train_time_s']:.2f} s, "
        f"{res['train_time_s'] * 1e3 / STATIC_ITERS:.2f} ms per step "
        f"(densifications included, host clock, read at the end); loss "
        f"{res['initial_loss']:.5f} (first 50) -> {res['final_loss']:.5f} "
        f"(last 50); live splats at the log points {points}; train-view "
        f"PSNR {psnr0:.2f} dB (initial cloud) -> {res['train_psnr']:.2f} dB; "
        f"SH degree {res['sh_degree']}; kernel launches "
        f"{res['kernel_launches']}")
    if not (np.isfinite(res["initial_loss"])
            and np.isfinite(res["final_loss"])
            and res["final_loss"] < res["initial_loss"]):
        raise AssertionError("train.static: the loss did not fall")
    if not res["train_psnr"] >= psnr0 + STATIC_PSNR_GAIN:
        raise AssertionError(f"train.static: PSNR {res['train_psnr']:.2f} "
                             f"dB, not {STATIC_PSNR_GAIN} dB above the "
                             f"initial {psnr0:.2f} dB")
    before = points[(oc.densify_from_iter // 200) - 1]
    if not any(p != before for p in points[oc.densify_from_iter // 200:]):
        raise AssertionError("no densification changed the live count")
    if res["sh_degree"] != 1:
        raise AssertionError(f"SH degree {res['sh_degree']} at the end")
    if any(v != STATIC_ITERS for v in res["kernel_launches"].values()):
        raise AssertionError("expected one launch of each kernel a step: "
                             f"{res['kernel_launches']}")
    launches = dict(res["kernel_launches"])

    # the CLI in process: its PLY equals its final state
    run2 = os.path.join(tmp.name, "static_in_process")
    (st2, _, res2), _, in_s, n2 = _in_process(S.main, [
        "--source_path", scene, "--model_path", run2, "--iterations",
        str(STATIC_CLI_CHECK_ITERS), "--device", dev.type])
    ply2 = load_gaussian_ply(os.path.join(run2, "point_cloud.ply"), capacity,
                             st2.max_sh_degree, dev)
    n = int(st2.num_alive())
    for f in G.PARAM_FIELDS:
        if f != "identity" and not torch.equal(
                getattr(ply2.params, f)[:n], getattr(st2.params, f)[st2.alive]):
            raise AssertionError(f"point_cloud.ply {f} differs from the state")
    if any(v != STATIC_CLI_CHECK_ITERS
           for v in res2["kernel_launches"].values()):
        raise AssertionError(f"in-process CLI: {res2['kernel_launches']}")
    launches = {k: launches[k] + n2[k] for k in launches}
    log(f"[{card}] train.static in process, {STATIC_CLI_CHECK_ITERS} steps: "
        f"{in_s:.2f} s; its point_cloud.ply ({n} splats) reloaded equal to "
        f"its final state; kernel launches {n2}")

    # the CLI's final cloud, from its PLY, at SH degree 1 as it ended
    state = load_gaussian_ply(os.path.join(run, "point_cloud.ply"), capacity,
                              mc.sh_degree, dev).replace(active_sh_degree=1)
    n_live = int(state.num_alive())
    step = S.make_train_step(cfg, oc, extent)
    gopt = G.adam_init(state.params)
    rng = np.random.default_rng(1)
    frames = [int(rng.integers(batch.num_frames))
              for _ in range(STATIC_STEPS_ALONE)]
    fns = kernel_fns()
    for f in fns:
        f.launches = 0
    times = []
    for k, i in enumerate(frames):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, gopt, loss = step(state, gopt, batch, i, STATIC_ITERS + 1 + k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    alone = {f.__name__: f.launches for f in fns}
    if any(v != STATIC_STEPS_ALONE for v in alone.values()):
        raise AssertionError(f"steps alone: {alone}")
    launches = {k: launches[k] + alone[k] for k in launches}
    step_ms = statistics.median(times[5:])
    log(f"[{card}] static step alone on the final cloud ({n_live} live of "
        f"{capacity}): median {step_ms:.3f} ms over {len(times) - 5} steps "
        f"(min {min(times[5:]):.3f}, max {max(times[5:]):.3f}; host clock "
        f"around synchronize), loss {float(loss):.5f}")

    # one step's gradients through the kernels against plain autograd, both
    # fed one cotangent: the step loss's gradient with respect to the
    # composited image, taken through the plain composite. On a fitted
    # cloud many residuals are within the two composites' rounding of 0,
    # where L1's gradient may take opposite signs; fed their own
    # cotangents the two paths then differ by up to 6.5x the tolerance on
    # 3 of 8 views, with D-SSIM or without it (measured on one H100 with
    # scripts/probe_static_parity.py; PERF.md).
    plain_cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=mc.max_per_tile,
                                backend="plain")
    cam0, gt0, bg0 = batch.camera(0), batch.gt_image(0), batch.bg_image(0)
    with torch.no_grad():
        loss_k, loss_p = (float(S.step_loss(c, oc, batch, 0)(
            state, torch.zeros((capacity, 2), device=dev))[0])
            for c in (cfg, plain_cfg))
        out_p = render(plain_cfg, cam0, state, torch.zeros(3, device=dev))
    img_p = (out_p.image + bg0 * (1.0 - out_p.alpha)).requires_grad_(True)
    cot, = torch.autograd.grad(rgb_loss(img_p, gt0, oc.lambda_dssim), img_p)

    def grads(c):
        def fn(st, off):
            out = render(c, cam0, st, torch.zeros(3, device=dev),
                         means2d_offset=off)
            return ((out.image + bg0 * (1.0 - out.alpha)) * cot).sum(), out
        _, _, g, g_off = gaussian_backward(fn, state, ())
        out = {f: getattr(g, f) for f in G.PARAM_FIELDS}
        out["means2d_offset"] = g_off
        return out

    g_k, g_p = grads(cfg), grads(plain_cfg)
    worst = max(check_close(f"static step gradient {k}", g_k[k], g_p[k],
                            GRAD_RTOL, GRAD_ATOL_FRAC) for k in g_p)
    log(f"  static step, kernels vs plain autograd: loss {loss_k:.6f} vs "
        f"{loss_p:.6f}; with one cotangent, {len(g_p)} gradient tensors "
        f"within {worst:.3f} of the tolerance")
    if not abs(loss_k - loss_p) <= 1e-4 * abs(loss_p):
        raise AssertionError("static step: loss mismatch")

    # a reference checkpoint of this cloud and its Adam state, imported
    alive = state.alive
    names = {"xyz": "xyz", "f_dc": "features_dc", "f_rest": "features_rest",
             "identity": "identity", "scaling": "scaling",
             "rotation": "rotation", "opacity": "opacity"}
    opt_sd = {"state": {}, "param_groups": []}
    for pid, (ref_name, f) in enumerate(names.items()):
        opt_sd["state"][pid] = {
            "step": torch.tensor(float(gopt.step)),
            "exp_avg": getattr(gopt.mu, f)[alive],
            "exp_avg_sq": getattr(gopt.nu, f)[alive]}
        opt_sd["param_groups"].append({"name": ref_name, "params": [pid]})
    capture = (state.active_sh_degree,
               *(getattr(state.params, f)[alive] for f in names.values()),
               state.max_radii2d[alive], state.xyz_grad_accum[alive, None],
               state.denom[alive, None], opt_sd, state.spatial_lr_scale,
               None, None)
    pth = os.path.join(tmp.name, "reference_capture.pth")
    torch.save(capture, pth)
    t = time.perf_counter()
    conv = convert_capture(torch.load(pth, map_location=dev,
                                      weights_only=False),
                           capacity, mc.audio_extractor, "face")
    imported = state_from_dict(conv["state"], dev)
    i_gopt = gopt_from_dict(conv["gopt"], dev)
    import_s = time.perf_counter() - t
    zero = torch.zeros(3, device=dev)
    with torch.no_grad():
        img_src = render(cfg, batch.camera(0), state, zero).image
        img_imp = render(cfg, batch.camera(0), imported, zero).image
    if not torch.equal(img_src, img_imp):
        raise AssertionError("the imported cloud renders differently")
    for f in G.PARAM_FIELDS:
        if not (torch.equal(getattr(i_gopt.mu, f)[:n_live],
                            getattr(gopt.mu, f)[alive])
                and torch.equal(getattr(i_gopt.nu, f)[:n_live],
                                getattr(gopt.nu, f)[alive])):
            raise AssertionError(f"imported Adam moments of {f} differ")
    if i_gopt.step != gopt.step:
        raise AssertionError("imported Adam step differs")
    log(f"[{card}] reference capture() of the final cloud ({n_live} splats, "
        f"named Adam groups) through torch.save, convert_capture on the "
        f"card, state_from_dict and gopt_from_dict in {import_s:.2f} s: its "
        f"render bit-equal to the source's, the moments equal")

    # densifications on the final cloud, its statistics from the steps
    gen = torch.Generator(dev).manual_seed(0)
    for k in range(STATIC_DENSIFY_TIMED):
        noise = torch.randn((2, capacity, 3), generator=gen, device=dev)
        before = int(state.num_alive())
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, gopt = S.densify_step(state, gopt, noise, False,
                                     oc.densify_grad_threshold, 0.005,
                                     extent, oc.percent_dense)
        torch.cuda.synchronize()
        log(f"[{card}] densify_and_prune on the final cloud: "
            f"{(time.perf_counter() - t) * 1e3:.2f} ms, live {before} -> "
            f"{int(state.num_alive())}")
        state, gopt, _ = step(state, gopt, batch, frames[k], STATIC_ITERS)

    prof = profile_runs(lambda: step(state, gopt, batch, 0, STATIC_ITERS))
    log(f"[{card}] profiled static step: {prof['wall_ms']:.3f} ms wall "
        f"under the profiler, {prof['device_ms']:.3f} ms of device kernels "
        f"({prof['device_ms'] / prof['wall_ms']:.1%} busy), "
        f"{prof['launches']:.0f} kernel launches")
    for kname, count, ms in prof["kernels"]:
        log(f"  device {ms:8.3f} ms {count:6.0f}x  {kname}")
    for op, count, ms in prof["host"]:
        log(f"  host   {ms:8.3f} ms {count:6.0f}x  {op}")

    # the three kernels at this cloud's step shape (C=8, A=0)
    cam = batch.camera(0)
    with torch.no_grad():
        prep = prepare(cfg, state.params.xyz, state.get_scaling(),
                       state.get_rotation(), cam.view_transform,
                       cam.full_proj_transform, cam.camera_center,
                       cam.tanfovx, cam.tanfovy, active=state.alive)
        colors = sh_colors(state.params.xyz, cam.camera_center,
                           _masked_features(state), state.max_sh_degree)
        opac = state.get_opacity().reshape(-1)
        feats, cnt = tile_features(prep.px, prep.py, prep.proj, opac, colors,
                                   torch.ones_like(opac), prep.ids,
                                   prep.valid)
        g = torch.randn((feats.shape[1], 10, 256), device=dev,
                        generator=torch.Generator(dev).manual_seed(13))
        ids = prep.ids.contiguous()
        case = training_kernel_checks("static cloud", feats, cnt, g, ids,
                                      capacity, cfg.tiles_x, 0,
                                      edge_aware=True)
        timed = time_training_kernels("static cloud", card, case, ids,
                                      prep.valid, capacity, cfg.tiles_x,
                                      n_aux=0)

    # the brute-force oracle on the card against the kernel-backed path,
    # and cov3d_precomp against scales and rotations
    (means, op, scales, rots, shs, view, full, campos), tanfov = \
        _oracle_scene(dev)
    o_cfg = RasterizeConfig(ORACLE_SIZE, ORACLE_SIZE, max_per_tile=256)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)
    args = (o_cfg, means, op, scales, rots, view, full, campos, tanfov,
            tanfov, bg)
    with torch.no_grad():
        out = rasterize(*args, shs=shs, sh_degree=1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ref = splat_reference(*args, shs=shs, sh_degree=1, bbox_sigma=4.0)
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t
        errs = {k: float((o.double() - r).abs().max()) for k, o, r in (
            ("image", out.image, ref[0]), ("depth", out.depth, ref[1]),
            ("normal", out.normal, ref[2]), ("alpha", out.alpha, ref[3]))}
        R = quat_to_rotmat(safe_normalize(rots)).double()
        sig = torch.einsum("nij,nj,nkj->nik", R, scales.double() ** 2, R)
        cov6 = torch.stack([sig[:, 0, 0], sig[:, 0, 1], sig[:, 0, 2],
                            sig[:, 1, 1], sig[:, 1, 2], sig[:, 2, 2]],
                           1).float()
        out_cv = rasterize(*args, shs=shs, sh_degree=1, cov3d_precomp=cov6)
        cov_err = float((out_cv.image - out.image).abs().max())
    log(f"[{card}] oracle ({ORACLE_SPLATS} splats, SH 1, "
        f"{ORACLE_SIZE}x{ORACLE_SIZE}, bbox_sigma 4, float64 on the card, "
        f"{oracle_s:.2f} s) against the kernel path: max |diff| "
        + ", ".join(f"{k} {v:.2e} (bound {ORACLE_ATOL[k]})"
                    for k, v in errs.items())
        + f"; cov3d_precomp against scales/rotations: image {cov_err:.2e} "
        f"(bound {COV3D_ATOL}), radii equal "
        f"{torch.equal(out_cv.radii, out.radii)}")
    if not all(errs[k] <= ORACLE_ATOL[k] for k in errs):
        raise AssertionError("the kernel path disagrees with the oracle")
    if not (cov_err <= COV3D_ATOL and torch.equal(out_cv.radii, out.radii)):
        raise AssertionError("cov3d_precomp disagrees")

    # the AVE encoder on the card against the CPU over a wav's crops
    wav = os.path.join(tmp.name, "speech.wav")
    _speech_wav(wav)
    windows = AudioWindows(load_wav(wav))
    mel = torch.from_numpy(np.stack([windows[i]
                                     for i in range(len(windows))]))
    gen = torch.Generator().manual_seed(3)
    enc = AudioEncoder()
    with torch.no_grad():
        for name, t_ in enc.state_dict().items():
            if name.endswith("conv.weight"):      # variance 2 / fan-in
                t_.copy_(torch.randn(t_.shape, generator=gen)
                         * (2.0 / t_[0].numel()) ** 0.5)
            elif name.endswith(("bn.weight", "running_var")):
                t_.copy_(0.5 + torch.rand(t_.shape, generator=gen))
            elif t_.is_floating_point():
                t_.copy_(0.1 * torch.randn(t_.shape, generator=gen))
    enc = enc.eval()
    with torch.no_grad():
        want = enc(mel)
        got = enc.to(dev)(mel.to(dev)).cpu()
    ave_err = float((got - want).abs().max() / want.abs().max())
    log(f"[{card}] AVE encoder on {len(mel)} mel crops [1, 80, 16] of a "
        f"2 s wav: card vs CPU max |diff| {ave_err:.2e} of the output's "
        f"scale (bound {AVE_TOL})")
    if not ave_err <= AVE_TOL:
        raise AssertionError("AVE encoder: card and CPU differ")
    tmp.cleanup()
    return {"launches": launches, "timed": timed}


def preprocessing_seam(card: str, dev: torch.device,
                       before_training) -> dict:
    """Phase 16: a raw capture through ``data_utils.process`` on the card
    and into ``cli.train_face``, with its checks and times. Returns each
    kernel's launches on the training run, its temporary directory and
    the scene directory (``base``). ``before_training(capture)`` runs
    before the training run, with the capture (its temporary directory,
    scene directory and video): phase 17, then the wait for the splat
    kernels' build."""
    import shutil
    import tempfile

    from instag_torch.cli import train_face as train_face_cli
    from instag_torch.config import ModelConfig, OptimizationConfig
    from instag_torch.data import dataset as D
    from instag_torch.data.image_io import (decode_jpegs, encode_jpeg,
                                            read_jpegs, read_png)
    from instag_torch.data.synthetic_hard import render_hard_video
    from instag_torch.data_utils import process as P
    from instag_torch.data_utils.audio_features import extract_ave
    from instag_torch.data_utils.tracker import track_poses
    from instag_torch.models import gaussians as G
    from instag_torch.train.common import (frame_source,
                                           load_training_frames)

    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    total = SEAM_FRAMES + SEAM_VAL
    torch.cuda.synchronize()
    t = time.perf_counter()
    video, stub = render_hard_video(root, n_frames=SEAM_FRAMES, size=SIZE,
                                    n_val=SEAM_VAL, supersample=2,
                                    device=dev)
    render_s = time.perf_counter() - t
    base = os.path.dirname(video)

    # the chain as a user runs it
    cmd = [sys.executable, "-m", "instag_torch.data_utils.process", video,
           "--task", "-1", "--synthetic_gt", stub, "--device", dev.type]
    t = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    process_s = time.perf_counter() - t
    lines = (proc.stdout + proc.stderr).strip().splitlines()
    for line in (lines[-30:] if proc.returncode else lines):
        log(f"  process | {line}")
    if proc.returncode != 0:
        raise AssertionError(f"data_utils.process exited {proc.returncode}")
    walls = {int(x.split()[2].rstrip(":")): float(x.split()[3])
             for x in lines if x.startswith("[process] task ")}
    log(f"[{card}] capture: {SIZE}x{SIZE}, {SEAM_FRAMES} + {SEAM_VAL} "
        f"frames at 2x supersampling rendered and written (MJPEG AVI by "
        f"nvJPEG, WAV, stub) in {render_s:.2f} s; process --task -1 "
        f"--synthetic_gt: exit 0 in {process_s:.2f} s wall as a process, "
        f"tasks " + ", ".join(f"{k}: {v:.3f} s" for k, v in walls.items()))

    # the contract of tests/test_e2e_seam.py
    for f in ["aud.wav", "aud_ds.npy", "bc.jpg", "au.csv",
              "transforms_train.json", "transforms_val.json",
              "track_params.npz"]:
        if not os.path.exists(os.path.join(base, f)):
            raise AssertionError(f"process wrote no {f}")
    for d in ["ori_imgs", "gt_imgs", "torso_imgs", "parsing", "teeth_mask"]:
        if not os.path.isdir(os.path.join(base, d)):
            raise AssertionError(f"process wrote no {d}/")
    aud = np.load(os.path.join(base, "aud_ds.npy"))
    if aud.shape != (total, 16, 29) or not np.isfinite(aud).all():
        raise AssertionError(f"aud_ds.npy {aud.shape}")

    # the extracted frames against the frames the capture was made from
    ids = range(total)
    ori = read_jpegs([os.path.join(base, "ori_imgs", f"{i}.jpg")
                      for i in ids], dev)
    src = read_jpegs([os.path.join(stub, "gt_imgs", f"{i}.jpg")
                      for i in ids], dev)
    psnrs = [_psnr(a.cpu().numpy(), b.cpu().numpy())
             for a, b in zip(ori, src)]

    # task 8 on the CPU over the same landmarks
    cpu_dir = os.path.join(root, "track_cpu")
    os.makedirs(os.path.join(cpu_dir, "ori_imgs"))
    for f in os.listdir(os.path.join(base, "ori_imgs")):
        if f.endswith(".lms") or f == "0.jpg":
            shutil.copy(os.path.join(base, "ori_imgs", f),
                        os.path.join(cpu_dir, "ori_imgs", f))
    with contextlib.redirect_stdout(io.StringIO()):
        track_poses(cpu_dir, os.path.join(cpu_dir, "ori_imgs"),
                    device="cpu")
    want = dict(np.load(os.path.join(cpu_dir, "track_params.npz")))
    got = dict(np.load(os.path.join(base, "track_params.npz")))
    pose_err = max(float(np.abs(got[k] - want[k]).max()
                         / max(1.0, float(np.abs(want[k]).max())))
                   for k in want)

    # tasks 5-6 on the CPU: from the inputs the card decoded, encoded as
    # the card encodes (byte-equal), and from libjpeg's decode through PIL,
    # where it imports (within SEAM_LEVELS), on every SEAM_CHECK_EVERY-th
    # frame and the plate
    paths = P._by_index([os.path.join(base, "ori_imgs", f"{i}.jpg")
                         for i in ids])
    sampled = paths[::20]
    parses = np.stack([read_png(P._parsing_path(p), 3) for p in sampled])
    plate = P.background_plate(read_jpegs(sampled, dev).cpu().numpy(),
                               parses)
    with open(os.path.join(base, "bc.jpg"), "rb") as f:
        bc_same = f.read() == encode_jpeg(torch.from_numpy(plate).to(dev),
                                          P.JPEG_QUALITY)
    bc = read_jpegs([os.path.join(base, "bc.jpg")], dev)[0].cpu().numpy()
    checked = paths[::SEAM_CHECK_EVERY]
    card_gt = read_jpegs([p.replace("ori_imgs", "gt_imgs") for p in checked],
                         dev).cpu().numpy()
    card_torso = [read_png(p.replace("ori_imgs", "torso_imgs")
                           .replace(".jpg", ".png"), 4) for p in checked]
    segs = [read_png(P._parsing_path(p), 3) for p in checked]
    same = 0
    for path, img, seg, torso_card in zip(
            checked, read_jpegs(checked, dev).cpu().numpy(), segs,
            card_torso):
        gt, torso = P.torso_and_gt(img, seg, bc)
        with open(path.replace("ori_imgs", "gt_imgs"), "rb") as f:
            same += (f.read() == encode_jpeg(torch.from_numpy(gt).to(dev),
                                             P.JPEG_QUALITY)
                     and np.array_equal(torso, torso_card))
    libjpeg = None
    if importlib.util.find_spec("PIL") is not None:
        # the CPU run: PIL decodes and encodes, and task 6 reads the plate
        # back from its own bc.jpg
        cpu = torch.device("cpu")
        plate = P.background_plate(read_jpegs(sampled, cpu).numpy(), parses)
        bc_cpu = decode_jpegs([encode_jpeg(plate, P.JPEG_QUALITY)],
                              cpu)[0].numpy()
        gts, torsos = [], []
        for img, seg in zip(read_jpegs(checked, cpu).numpy(), segs):
            gt, torso = P.torso_and_gt(img, seg, bc_cpu)
            gts.append(decode_jpegs([encode_jpeg(gt, P.JPEG_QUALITY)],
                                    cpu)[0].numpy())
            torsos.append(torso)
        levels = {"bc.jpg": np.abs(bc_cpu.astype(int) - bc),
                  "gt_imgs": np.abs(np.stack(gts).astype(int) - card_gt),
                  "torso_imgs": np.abs(np.stack(torsos).astype(int)
                                       - np.stack(card_torso))}
        libjpeg = {k: (int(v.max()), float(v.mean()))
                   for k, v in levels.items()}

    # task 2 with --asr ave, on the card and on the CPU
    with contextlib.redirect_stdout(io.StringIO()):
        P.main([video, "--task", "2", "--asr", "ave", "--device", dev.type])
        ave_cpu = os.path.join(root, "aud_ave_cpu.npy")
        extract_ave(os.path.join(base, "aud.wav"), ave_cpu, device="cpu")
    a_card = np.load(os.path.join(base, "aud_ave.npy"))
    a_cpu = np.load(ave_cpu)
    ave_err = float(np.abs(a_card - a_cpu).max() / np.abs(a_cpu).max())
    log(f"[{card}] seam checks: ori_imgs against the stub's frames PSNR min "
        f"{min(psnrs):.2f} dB, mean {np.mean(psnrs):.2f} (bound "
        f"{SEAM_PSNR_MIN}); track_params card vs CPU {pose_err:.2e} of "
        f"scale (focal {got['focal'][0]:.0f} both: "
        f"{got['focal'][0] == want['focal'][0]}); tasks 5-6 on the CPU from "
        f"the card's decoded inputs: bc.jpg byte-equal {bc_same}, gt_imgs "
        f"byte-equal and torso_imgs pixel-equal {same}/{len(checked)}; "
        f"from libjpeg's decode (PIL): max and mean |level| "
        + (str(libjpeg) + f" (bound {SEAM_LEVELS})" if libjpeg else
           "not checked, PIL does not import")
        + f"; AVE {a_card.shape} card vs CPU {ave_err:.2e} of scale "
        f"(tolerance {AVE_TOL})")
    if not min(psnrs) >= SEAM_PSNR_MIN:
        raise AssertionError(f"ori_imgs at {min(psnrs):.2f} dB")
    if not (got["focal"][0] == want["focal"][0]
            and pose_err <= SEAM_POSE_TOL):
        raise AssertionError("track_params differ from the CPU's")
    if not (bc_same and same == len(checked)):
        raise AssertionError("tasks 5-6 differ from the CPU's")
    if libjpeg and any(m > SEAM_LEVELS[0] or a > SEAM_LEVELS[1]
                       for m, a in libjpeg.values()):
        raise AssertionError(f"tasks 5-6 beyond {SEAM_LEVELS} of libjpeg's")
    if not (a_card.shape == (len(a_cpu), 512, 1) and ave_err <= AVE_TOL):
        raise AssertionError("AVE features differ from the CPU's")

    # training on the output, as a user runs it
    argv = ["-s", base, "--iterations", str(SEAM_ITERS), "--device",
            dev.type]
    before_training(dict(tmp=tmp, base=base, video=video))
    res, out, train_s, launches = _in_process(train_face_cli.main, argv)
    losses = np.array(res["losses"])
    first, last = losses[:50].mean(), losses[-50:].mean()
    noise = torch.randn((2, res["state"].capacity, 3), device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    oc = OptimizationConfig()                # the CLI's defaults
    alive0 = int(res["state"].num_alive())
    dens, _ = G.densify_and_prune(res["state"], res["gopt"], noise,
                                  oc.densify_grad_threshold, 0.05,
                                  res["extent"], None, oc.percent_dense)
    alive1 = int(dens.num_alive())
    log(f"[{card}] cli.train_face on the output: {SEAM_ITERS} steps at "
        f"{SIZE}x{SIZE}, ModelConfig() widths, in {train_s:.2f} s through "
        f"main (scene read included), {train_s * 1e3 / SEAM_ITERS:.2f} ms "
        f"per step; loss {first:.5f} (first 50) -> {last:.5f} (last 50); "
        f"kernel launches {launches}; one densification of the final "
        f"state: live splats {alive0} -> {alive1}")
    if len(losses) != SEAM_ITERS or not np.isfinite(losses).all():
        raise AssertionError("non-finite or missing losses")
    if not last < first:
        raise AssertionError("the loss did not fall on the output")
    if any(v != SEAM_ITERS for v in launches.values()):
        raise AssertionError(f"expected one launch of each kernel per step: "
                             f"{launches}")
    if alive1 == alive0:
        raise AssertionError("the densification changed no splat")
    del res, dens

    # streaming: the train split decoded into host memory in chunks, held
    # against the read on the card that the CLI made (memoized)
    mc = ModelConfig(source_path=base)
    records = load_training_frames(mc, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    m0 = torch.cuda.memory_allocated()
    t = time.perf_counter()
    host = load_training_frames(mc, dev, stream=True)
    store = frame_source(host, with_priors=True, stream=True, device=dev)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t
    grown = torch.cuda.memory_allocated() - m0
    peak = torch.cuda.max_memory_allocated() - m0
    chunk = (D.DECODE_CHUNK + 2) * SIZE * SIZE * 3     # frames, bc, planes
    split = 2 * len(records) * SIZE * SIZE * 3         # frames and bgs
    equal = all(torch.equal(a.image, b.image.cpu())
                and torch.equal(a.bg, b.bg.cpu())
                and a.image.device.type == "cpu"
                for a, b in zip(host, records))
    log(f"[{card}] streamed read of {len(host)} train frames: "
        f"{stream_s:.2f} s; card memory grew by {grown} bytes (peak "
        f"{peak}) against one decode chunk's {chunk} and the split's "
        f"{split}; frames bit-equal to the read on the card {equal}; "
        f"store pinned {store.host.image.is_pinned()}")
    if not (len(host) == len(records) and equal and grown <= chunk
            and peak <= chunk):
        raise AssertionError("the streamed read kept frames on the card")
    return dict(launches=launches, tmp=tmp, base=base)


def _fit_sequence(model, n: int, seed: int = 0) -> dict:
    """A head of ``model`` moving and speaking over ``n`` frames (the
    sequence of tests/test_tracker_photometric.py, stretched to n)."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, n)
    light = np.zeros((27,), np.float32)
    light[0:3] = [1.6, 1.5, 1.4]
    light[3:6] = 0.35
    f32 = np.float32
    return dict(
        id=(0.6 * rng.normal(size=(model.n_id,))).astype(f32),
        exp=(0.5 * rng.normal(size=(n, model.n_exp))).astype(f32),
        tex=(0.5 * rng.normal(size=(model.n_tex,))).astype(f32),
        euler=np.stack([0.08 * np.sin(3 * t), 0.12 * np.cos(2 * t),
                        0.04 * np.sin(1 + 3 * t)], -1).astype(f32),
        trans=np.stack([0.01 * np.sin(2 * t), 0.01 * np.cos(2 * t),
                        0.85 + 0.02 * np.sin(t)], -1).astype(f32),
        light=np.tile(light[None], (n, 1)))


def _saved_lan_err(model, path: str, lms: np.ndarray, c: float) -> tuple:
    """The landmark error (px) of a ``track_params.npz``: the model's
    landmarks under its saved (OpenGL) poses, id, exp and focal, against
    the landmarks; and the file's arrays."""
    from instag_torch.data_utils.face_model import landmarks3d
    from instag_torch.data_utils.photometric import euler2rot, project

    d = dict(np.load(path))
    F = np.diag([1.0, -1.0, -1.0])
    Rs = F @ euler2rot(torch.from_numpy(d["euler"])).numpy()
    ts = (d["trans"] / 10.0) @ F.T
    l3 = landmarks3d(model, torch.from_numpy(d["id"][:model.n_id])[None]
                     .repeat(len(lms), 1),
                     torch.from_numpy(d["exp"][:, :model.n_exp])).numpy()
    cam = np.einsum("tij,tnj->tni", Rs, l3) + ts[:, None]
    proj = project(torch.from_numpy(cam), float(d["focal"][0]), c, c)
    return float(np.linalg.norm(proj.numpy() - lms, axis=-1).mean()), d


def photometric_and_extractors(card: str, dev: torch.device, seam: dict):
    """Phase 17: the photometric 3DMM fit at full width on a sequence of
    the synthetic model, the fit on the card against the CPU, ``process
    --task 8`` with a morphable model on phase 16's capture, and tasks 4,
    7 and 11 through the learned extractors (random weights from a seed)
    on a copy of it, with each network's outputs against the CPU."""
    import shutil
    import tempfile

    from instag_torch.data.image_io import read_jpegs, read_png, write_jpeg
    from instag_torch.data_utils import cv_ops
    from instag_torch.data_utils import process as P
    from instag_torch.data_utils.easyportrait_fpn import (
        EasyPortraitFPN, load_fpn_fp, segment_logits)
    from instag_torch.data_utils.face_model import (
        geometry, landmarks3d, save_model, sh_shading, synthetic_model,
        texture, to_device, vertex_normals)
    from instag_torch.data_utils.face_parsing import (BiSeNet,
                                                      colorize_parsing,
                                                      load_bisenet,
                                                      parsing_logits)
    from instag_torch.data_utils.landmarks import (
        LandmarkTracker, bbox_to_center_scale, build_fan, load_fan)
    from instag_torch.data_utils.mesh_render import (MeshRenderConfig,
                                                     render_mesh)
    from instag_torch.data_utils.photometric import (fit_photometric,
                                                     project,
                                                     transform_points)
    from instag_torch.data_utils.tracker import track_poses

    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    model = synthetic_model()
    c = SIZE / 2.0

    # (a) a 50-frame sequence of the synthetic model rendered on the card
    # at 512x512, its JPEGs through nvJPEG, with its landmarks
    torch.cuda.synchronize()
    t = time.perf_counter()
    seq = _fit_sequence(model, FIT_FRAMES)
    m = to_device(model, dev)
    cfg = MeshRenderConfig(SIZE, SIZE)
    fit_dir = os.path.join(tmp.name, "fit")
    ori = os.path.join(fit_dir, "ori_imgs")
    os.makedirs(ori)
    g = {k: torch.from_numpy(v).to(dev) for k, v in seq.items()}
    lms = []
    with torch.no_grad():
        for s0 in range(0, FIT_FRAMES, 10):
            sl = slice(s0, min(s0 + 10, FIT_FRAMES))
            n = sl.stop - sl.start
            ids = g["id"][None].expand(n, -1)
            vc = transform_points(geometry(m, ids, g["exp"][sl]),
                                  g["euler"][sl], g["trans"][sl])
            shade = torch.clamp_min(sh_shading(vertex_normals(vc, m.tris),
                                               g["light"][sl]), 0.0)
            cols = torch.clamp(texture(m, g["tex"]) * shade, 0.0, 1.0)
            rgba = render_mesh(cfg, vc, m.tris, cols, FIT_FOCAL, c, c)
            lms.append(project(transform_points(
                landmarks3d(m, ids, g["exp"][sl]), g["euler"][sl],
                g["trans"][sl]), FIT_FOCAL, c, c).cpu().numpy())
            for i, img in zip(range(sl.start, sl.stop), rgba):
                write_jpeg(os.path.join(ori, f"{i}.jpg"),
                           (img[..., :3].clamp(0, 1) * 255).to(torch.uint8))
    lms = np.concatenate(lms)
    for i in range(FIT_FRAMES):
        np.savetxt(os.path.join(ori, f"{i}.lms"), lms[i], "%f")
    covered = float(rgba[..., 3].mean())
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t

    quiet = contextlib.redirect_stdout(io.StringIO())
    params = os.path.join(fit_dir, "track_params.npz")
    t = time.perf_counter()
    with quiet:
        track_poses(fit_dir, ori, smooth=1, device=dev)
    pnp_s = time.perf_counter() - t
    err_pnp, d_pnp = _saved_lan_err(model, params, lms, c)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        fit = track_poses(fit_dir, ori, smooth=1, model=model,
                          downscale=FIT_DOWNSCALE,
                          photometric_iters=FIT_ITERS, device=dev)
    fit_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    err_fit, d = _saved_lan_err(model, params, lms, c)
    walls = fit["stage_seconds"]
    log(f"[{card}] photometric fit: {FIT_FRAMES} frames of the synthetic "
        f"model ({len(model.tris)} triangles) rendered at {SIZE}x{SIZE} and "
        f"written by nvJPEG in {seq_s:.2f} s (last frame {covered:.3f} "
        f"covered); track_poses PnP alone {pnp_s:.2f} s (focal "
        f"{d_pnp['focal'][0]:.0f}), with the model at downscale "
        f"{FIT_DOWNSCALE} and iters {FIT_ITERS} {fit_s:.2f} s (stages "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
        + f"; peak card memory {peak / 2**20:.1f} MiB); saved landmark "
        f"error {err_fit:.4f} px against PnP's {err_pnp:.4f}; max |exp| "
        f"{np.abs(d['exp']).max():.4f}, |light| {np.abs(d['light']).max():.4f}"
        f", |id| {np.abs(d['id']).max():.4f}; stage losses "
        f"{ {k: round(v, 5) for k, v in fit['stage_losses'].items()} }")
    if not (np.abs(d["exp"]).max() > 1e-3 and np.abs(d["light"]).max() > 1e-3
            and err_fit <= err_pnp + 1e-3):
        raise AssertionError("the photometric fit did not improve on PnP")

    # the fit's inputs at 128x128, as the tracker made them
    ds = FIT_DOWNSCALE
    imgs = np.stack([cv_ops.resize_area(im, (SIZE // ds, SIZE // ds))
                     for im in read_jpegs(
                         [os.path.join(ori, f"{i}.jpg")
                          for i in range(FIT_FRAMES)], dev).cpu().numpy()]
                    ).astype(np.float32) / 255.0
    focal = float(d["focal"][0]) / ds
    start = dict(euler_init=np.zeros((FIT_FRAMES, 3), np.float32),
                 trans_init=np.tile(np.array([0, 0, 0.9], np.float32),
                                    (FIT_FRAMES, 1)))

    def stage_c(steps):
        return lambda: fit_photometric(
            model, lms / ds, imgs, focal, c / ds, c / ds,
            iters=(1, 1, steps, 0), device=dev, **start)
    one, two = profile_runs(stage_c(1), n=1), profile_runs(stage_c(2), n=1)
    log(f"[{card}] one stage-C step ({min(32, FIT_FRAMES)} frames at "
        f"{SIZE // ds}x{SIZE // ds}; the difference of two profiled fits "
        f"with 1 and 2 stage-C steps): "
        f"{two['device_ms'] - one['device_ms']:.3f} ms of device kernels in "
        f"{two['launches'] - one['launches']:.0f} launches; wall "
        f"{two['wall_ms'] - one['wall_ms']:.3f} ms under the profiler")
    for kname, count, ms in two["kernels"][:5]:
        log(f"  device {ms:8.3f} ms {count:6.0f}x  {kname}")

    # (b) the fit on the card against the CPU, on the same inputs
    sub = slice(0, FIT_CHECK_FRAMES)
    kw = dict(euler_init=start["euler_init"][sub],
              trans_init=start["trans_init"][sub], iters=FIT_CHECK_ITERS)
    t = time.perf_counter()
    got = fit_photometric(model, lms[sub] / ds, imgs[sub], focal, c / ds,
                          c / ds, device=dev, **kw)
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    want = fit_photometric(model, lms[sub] / ds, imgs[sub], focal, c / ds,
                           c / ds, device="cpu", **kw)
    cpu_s = time.perf_counter() - t
    errs = {k: float(np.abs(got[k] - want[k]).max()
                     / max(np.abs(want[k]).max(), 1e-12))
            for k in ("id", "exp", "tex", "euler", "trans", "light")}
    log(f"[{card}] fit_photometric iters {FIT_CHECK_ITERS} on "
        f"{FIT_CHECK_FRAMES} frames at {SIZE // ds}x{SIZE // ds}: card "
        f"{card_s:.2f} s, CPU {cpu_s:.2f} s; card vs CPU of scale "
        f"{ {k: f'{v:.2e}' for k, v in errs.items()} } (rtol {FIT_RTOL}); "
        f"landmark error {got['lan_err_px']:.5f} vs "
        f"{want['lan_err_px']:.5f} px")
    if max(errs.values()) > FIT_RTOL:
        raise AssertionError(f"the fit on the card differs from the CPU's: "
                             f"{errs}")

    # (c) process --task 8 with a morphable model, on phase 16's capture
    base, video = seam["base"], seam["video"]
    os.makedirs(os.path.join(base, "3DMM"), exist_ok=True)
    save_model(os.path.join(base, "3DMM", "3dmm_model.npz"), model)
    cmd = [sys.executable, "-m", "instag_torch.data_utils.process", video,
           "--task", "8", "--device", dev.type]
    task8 = _Started(cmd, 300)      # read after (d), which works on copies
    total = SEAM_FRAMES + SEAM_VAL

    def task8_checks():
        proc, task8_s = task8.result()
        lines = (proc.stdout + proc.stderr).strip().splitlines()
        for line in (lines[-30:] if proc.returncode else lines):
            log(f"  process | {line}")
        if proc.returncode != 0:
            raise AssertionError(f"process --task 8 exited {proc.returncode}")
        tp = dict(np.load(os.path.join(base, "track_params.npz")))
        log(f"[{card}] process --task 8 with 3DMM/3dmm_model.npz on phase "
            f"16's capture: exit 0 in {task8_s:.2f} s as a process, beside "
            f"(d); exp {tp['exp'].shape}, max |id| "
            f"{np.abs(tp['id']).max():.4f}, |exp| "
            f"{np.abs(tp['exp']).max():.4f}, |light| "
            f"{np.abs(tp['light']).max():.4f}")
        if not (tp["euler"].shape == (total, 3)
                and tp["exp"].shape == (total, 79)
                and tp["light"].shape == (total, 27)
                and all(np.abs(tp[k]).max() > 0
                        for k in ("id", "exp", "light"))
                and all(np.isfinite(v).all() for v in tp.values())):
            raise AssertionError("task 8 wrote no fit")

    # (d) tasks 4, 7 and 11 through the learned extractors, random weights
    # from a seed in the public checkpoints' layouts, on a copy of the
    # capture
    torch.manual_seed(0)
    wdir = os.path.join(tmp.name, "weights")
    os.makedirs(wdir)
    nets = {"fan": build_fan(4), "bisenet": BiSeNet(),
            "fpn": EasyPortraitFPN()}
    paths = {k: os.path.join(wdir, f"{k}.pth") for k in nets}
    torch.save(nets["fan"].state_dict(), paths["fan"])
    torch.save(nets["bisenet"].state_dict(), paths["bisenet"])
    torch.save({"state_dict": nets["fpn"].state_dict()}, paths["fpn"])
    del nets
    env = {"INSTAG_FAN_WEIGHTS": paths["fan"],
           "INSTAG_BISENET_WEIGHTS": paths["bisenet"],
           "INSTAG_EASYPORTRAIT_FPN": paths["fpn"],
           "INSTAG_TEETH_MODEL": os.path.join(wdir, "absent.pt")}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    copies = {"4": (os.path.join(tmp.name, "capture"), total),
              "11": (os.path.join(tmp.name, "capture"), total),
              "7": (os.path.join(tmp.name, "tracked"), FAN_TRACK_FRAMES)}
    for d, n in set(copies.values()):
        os.makedirs(os.path.join(d, "ori_imgs"))
        for i in range(n):
            shutil.copy(os.path.join(base, "ori_imgs", f"{i}.jpg"),
                        os.path.join(d, "ori_imgs"))
    walls = {}
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            for task, (d, _) in copies.items():
                walls.update(P.main([os.path.join(d, "v.avi"), "--task",
                                     task, "--device", dev.type]))
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    copy, tracked = copies["4"][0], copies["7"][0]
    parsing = [read_png(os.path.join(copy, "parsing", f"{i}.png"), 3)
               for i in range(total)]
    marks = [np.loadtxt(os.path.join(tracked, "ori_imgs", f"{i}.lms"))
             for i in range(FAN_TRACK_FRAMES)]
    teeth = [np.load(os.path.join(copy, "teeth_mask", f"{i}.npy"))
             for i in range(total)]
    if not (all(p.shape == (SIZE, SIZE, 3) and p.dtype == np.uint8
                for p in parsing)
            and all(x.shape == (68, 2) and np.isfinite(x).all()
                    for x in marks)
            and all(x.shape == (SIZE, SIZE) and x.dtype == bool
                    for x in teeth)):
        raise AssertionError("tasks 4, 7 and 11 wrote malformed files")

    # each network's raw output on 2 frames, card against CPU, and the
    # files of the first frames made on the CPU
    cpu = torch.device("cpu")
    frames = read_jpegs([os.path.join(copy, "ori_imgs", f"{i}.jpg")
                         for i in range(total)], dev).cpu().numpy()
    fan = {x: load_fan(paths["fan"], x) for x in (dev, cpu)}
    bis = {x: load_bisenet(paths["bisenet"], x) for x in (dev, cpu)}
    fpn = {x: load_fpn_fp(paths["fpn"], x) for x in (dev, cpu)}
    s = SIZE * 0.8
    box = bbox_to_center_scale([c - s / 2, c - s / 2, c + s / 2, c + s / 2])
    outs = {"fan": lambda net, img: LandmarkTracker(net, device=next(
                net.parameters()).device).heatmaps(img, *box),
            "bisenet": parsing_logits, "fpn": segment_logits}
    net_err = {}
    for name, pair in (("fan", fan), ("bisenet", bis), ("fpn", fpn)):
        err = 0.0
        for img in frames[:2]:
            a = np.asarray(torch.as_tensor(outs[name](pair[dev], img)).cpu())
            b = np.asarray(torch.as_tensor(outs[name](pair[cpu], img)))
            err = max(err, float(np.abs(a - b).max() / np.abs(b).max()))
        net_err[name] = err
    order = sorted(f for f in os.listdir(os.path.join(tracked, "ori_imgs"))
                   if f.endswith(".jpg"))[:NET_CPU_FRAMES]
    tracker = LandmarkTracker(fan[cpu], device=cpu)
    same_lms = same_px = same_teeth = n_px = 0
    for f in order:
        i = int(f.split(".")[0])
        same_lms += int((np.abs(tracker(frames[i]) - marks[i]) < 1e-6).all(
            -1).sum())
        logits = parsing_logits(bis[cpu], frames[i]).argmax(0).numpy()
        color = cv_ops.resize_nearest(colorize_parsing(logits.astype(
            np.uint8)), (SIZE, SIZE))[..., ::-1]
        same_px += int((color == parsing[i]).all(-1).sum())
        cls = segment_logits(fpn[cpu], frames[i]).argmax(0).numpy()
        same_teeth += int(((cls == 7) == teeth[i]).sum())
        n_px += SIZE * SIZE
    x_fan = torch.zeros((1, 3, 256, 256), device=dev)
    x_img = torch.zeros((1, 3, SIZE, SIZE), device=dev)
    with torch.no_grad():
        ms = {"fan (256x256 crop)": cuda_ms(lambda: fan[dev](x_fan), reps=3,
                                            rounds=3, warmup=1),
              "bisenet": cuda_ms(lambda: bis[dev](x_img), reps=3, rounds=3,
                                 warmup=1),
              "fpn": cuda_ms(lambda: fpn[dev](x_img), reps=3, rounds=3,
                             warmup=1)}
    log(f"[{card}] tasks 4, 7, 11 through the extractors (random weights, "
        f"seed 0) on a copy of phase 16's capture: {total} frames for tasks "
        f"4 and 11, the first {FAN_TRACK_FRAMES} for task 7; last box "
        f"tracked {np.ptp(marks[-1], 0).round(1)} px wide and high; "
        f"task walls {({k: round(v, 3) for k, v in walls.items()})} s; "
        f"files well-formed; raw outputs card vs CPU on 2 frames, of scale "
        f"{ {k: f'{v:.2e}' for k, v in net_err.items()} } (tolerance "
        f"{NET_TOL}); against the CPU on the first {len(order)} frames of "
        f"the tracking order: landmarks {same_lms}/{68 * len(order)} equal "
        f"(to 1e-6 px), parsing pixels {same_px}/{n_px}, teeth pixels "
        f"{same_teeth}/{n_px}; ms a frame at {SIZE}x{SIZE} on the card "
        f"(fp32, TF32 off): "
        f"{ {k: round(v, 3) for k, v in ms.items()} }")
    if max(net_err.values()) > NET_TOL:
        raise AssertionError(f"a network on the card differs from the CPU: "
                             f"{net_err}")
    task8_checks()
    tmp.cleanup()
    log(f"[{card}] phase 17: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# 19. the workflow scripts (scripts/torch/) as processes, as a user runs them
# ---------------------------------------------------------------------------

E2E_ARGS = ["20", "256", "40"]   # e2e_from_video.sh: frames, size, steps
SCRIPT_TIMEOUT = 900.0   # each workflow script's own time limit, seconds
# In each Python process a workflow script starts, this writes the three
# kernel wrappers' launch counts at exit into $CHIP_SMOKE_LAUNCHES, then
# hands over to any other sitecustomize on the path.
_LAUNCH_SITE = """import atexit, importlib.util, json, os, sys


def _dump():
    c = sys.modules.get("instag_torch.ops.composite")
    s = sys.modules.get("instag_torch.ops.scatter")
    if c is None:
        return
    rec = {"argv": sys.argv, "composite_fwd": c.composite_fwd.launches,
           "composite_bwd": c.composite_bwd.launches,
           "scatter_add_tiles": s.scatter_add_tiles.launches if s else 0}
    path = os.path.join(os.environ["CHIP_SMOKE_LAUNCHES"],
                        f"{os.getpid()}.json")
    with open(path, "w") as f:
        json.dump(rec, f)


atexit.register(_dump)
_here = os.path.dirname(os.path.abspath(__file__))
for _p in sys.path:
    _f = os.path.join(_p or ".", "sitecustomize.py")
    if os.path.abspath(_p or ".") != _here and os.path.exists(_f):
        _spec = importlib.util.spec_from_file_location("_next_site", _f)
        _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
        break
"""


def workflow_scripts_start(dev: torch.device) -> dict:
    """Phase 19, started: ``bash scripts/torch/e2e_from_video.sh`` (a
    capture of 20 frames at 256x256 through ``process`` and ``cli.adapt``
    with 40 steps a stage) and ``python scripts/torch/verify_drive.py`` as
    a user runs them, on the card, each under its own time limit and
    beside in-process work; every Python process they start records its
    kernel launches (``_LAUNCH_SITE``)."""
    tmp = tempfile.TemporaryDirectory()
    site = os.path.join(tmp.name, "site")
    os.makedirs(site)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(_LAUNCH_SITE)
    started = {"tmp": tmp}
    for name, cmd in (
            ("e2e", ["bash", "scripts/torch/e2e_from_video.sh",
                     os.path.join(tmp.name, "e2e"), *E2E_ARGS]),
            ("verify_drive", [sys.executable,
                              "scripts/torch/verify_drive.py",
                              "--device", dev.type])):
        counts = os.path.join(tmp.name, f"launches_{name}")
        os.makedirs(counts)
        env = dict(os.environ, CHIP_SMOKE_LAUNCHES=counts, PYTHONPATH=(
            site + os.pathsep + os.environ.get("PYTHONPATH", "")).rstrip(
                os.pathsep))
        started[name] = (_Started(cmd, SCRIPT_TIMEOUT, env=env), counts)
    return started


def _script_launches(counts: str) -> dict:
    total = dict.fromkeys(("composite_fwd", "composite_bwd",
                           "scatter_add_tiles"), 0)
    for name in os.listdir(counts):
        with open(os.path.join(counts, name)) as f:
            rec = json.load(f)
        for k in total:
            total[k] += rec[k]
    return total


def workflow_scripts(card: str, started: dict) -> dict:
    """Phase 19, read: each script's exit, outputs, wall and kernel
    launches. Returns the launches of both scripts' processes."""
    launches = {}
    for name in ("verify_drive", "e2e"):
        bg, counts = started[name]
        proc, wall = bg.result()
        lines = (proc.stdout + proc.stderr).strip().splitlines()
        if proc.returncode != 0:
            for line in lines[-30:]:
                log(f"  {name} | {line}")
            raise AssertionError(f"{name} exited {proc.returncode}")
        launches[name] = _script_launches(counts)
        if not all(v > 0 for v in launches[name].values()):
            raise AssertionError(f"{name}: a kernel was never launched: "
                                 f"{launches[name]}")
        if name == "e2e":
            out = os.path.join(started["tmp"].name, "e2e", "out")
            with open(os.path.join(out, "metrics.json")) as f:
                scores = json.load(f)
            if not all(np.isfinite(scores.get(k, np.nan))
                       for k in ("psnr", "lpips")):
                raise AssertionError(f"e2e metrics.json: {scores}")
            clip = [f for f in ("out.mp4", "out.mp4.frames.npz")
                    if os.path.exists(os.path.join(out, f))]
            if not clip:
                raise AssertionError("e2e: no clip frames file")
            log(f"[{card}] scripts/torch/e2e_from_video.sh "
                f"{' '.join(E2E_ARGS)}: exit 0 in {wall:.2f} s wall as a "
                f"process (beside phases 14-15); PSNR {scores['psnr']:.3f} "
                f"dB, LPIPS {scores['lpips']:.4f}; {clip[0]} written; "
                f"kernel launches {launches[name]}")
        else:
            fit = [x for x in lines if x.startswith("fit: PSNR")]
            if not (fit and "VERIFY DRIVE PASSED" in lines):
                raise AssertionError(f"verify_drive: {lines[-5:]}")
            log(f"[{card}] scripts/torch/verify_drive.py: exit 0 in "
                f"{wall:.2f} s wall as a process; {fit[0]}; behind-camera "
                f"and hash-grid probes passed; kernel launches "
                f"{launches[name]}")
    started["tmp"].cleanup()
    return {k: sum(v[k] for v in launches.values())
            for k in launches["e2e"]}


# ---------------------------------------------------------------------------
# 18. the parallel modes (parallel/): --data_parallel on one card and on
# 2 ranks, identity parallelism, tensor-parallel rendering, NCCL
# ---------------------------------------------------------------------------

PAR_DP = 4               # frames a data-parallel step
PAR_TIMED = 4            # dp=4 steps timed
PAR_CLI_ITERS = 12       # cli.train_face --data_parallel 4 steps
PAR_TIMEOUT = 240.0      # the 2-rank spawn's own time limit, seconds
DP_RTOL = 1e-4           # one dp step against another order of the same
DP_ATOL_FRAC = 1e-5      # fp32 sums (ranks, atomics): per element
TP_ATOL = {"image": 3e-5, "alpha": 3e-5}   # tests/test_tensor_parallel.py
TP_GRAD_ATOL = 2e-4      # of each gradient's largest |value|


def _dp_case(dev):
    """Phase 7's step cloud, nets and frames (from seeds), the dp step's
    flags and a ``step(dp, group)`` factory."""
    from instag_torch.bench_utils import (synthetic_frame_batch,
                                          synthetic_motion_params,
                                          synthetic_state)
    from instag_torch.config import OptimizationConfig
    from instag_torch.ops.rasterize import RasterizeConfig
    from instag_torch.train.face import Flags, make_face_step

    nets = synthetic_motion_params(seed=1, device=dev)
    state = synthetic_state(30000, 32768, seed=0, scale=0.004, device=dev)
    batch = synthetic_frame_batch(SIZE, n_frames=PAR_DP, device=dev)
    flags = Flags(align=1.0, use_regs=1.0, use_sapiens=0.0, use_depth=1.0,
                  hair_paint=0.0, use_lpips=0.0)
    cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256)

    def step(dp, group=None):
        return make_face_step(cfg, OptimizationConfig(), nets["face_umf"],
                              nets["face_pmf"], 1.0, False, device=dev,
                              dp=dp, group=group)
    return dict(nets=(nets["face_umf"], nets["face_pmf"]), state=state,
                batch=batch, flags=flags, step=step, cfg=cfg)


def _dp_grads(case, rows, group=None):
    """The dp=4 step's mean loss and gradients over this rank's ``rows``
    (no update): {name: tensor}, with the statistics' increments."""
    from instag_torch.models import gaussians as G
    from instag_torch.train.common import adaptation_grads
    step = case["step"](PAR_DP, group)
    loss, grads, stats = adaptation_grads(
        step, case["state"], rows, lambda st, off, i: step.loss(
            st, off, case["batch"], i, case["flags"]))
    st = G.add_frame_stats(case["state"], *stats)
    out = {f: getattr(grads, f) for f in G.PARAM_FIELDS}
    for net in case["nets"]:
        for n, p in net.named_parameters():
            out[f"{type(net).__name__}.{n}"] = p.grad.clone()
    out.update(xyz_grad_accum=st.xyz_grad_accum, denom=st.denom,
               max_radii2d=st.max_radii2d)
    return float(loss), out


def _close_all(label, ours, ref):
    """check_close over every tensor of two gradient dicts."""
    return max(check_close(f"{label} {k}", ours[k].to(ref[k].device),
                           ref[k], DP_RTOL, DP_ATOL_FRAC) for k in ref)


def _parallel_rank(rank, group, dev, ids_root):
    """One of phase 18's 2 ranks on the shared card (gloo): the dp=4 step
    at W = 2, one identity-parallel face motion step with the multi-process
    bundle, and a tensor-parallel frame. Returns numbers and launches."""
    import copy

    from instag_torch.bench_utils import synthetic_camera, synthetic_state
    from instag_torch.config import ModelConfig, OptimizationConfig
    from instag_torch.io.checkpoints import (bundle_list, flax_params,
                                             load_bundle)
    from instag_torch.io.from_jax import load_motion_net
    from instag_torch.models import gaussians as G
    from instag_torch.models.motion import (MotionNetwork,
                                            PersonalizedMotionNetwork,
                                            init_motion_params)
    from instag_torch.ops.rasterize import RasterizeConfig, rasterize
    from instag_torch.parallel.comm import check_replicas
    from instag_torch.parallel.identity_parallel import \
        make_idp_pretrain_step
    from instag_torch.parallel.mesh import shard_rows
    from instag_torch.parallel.multihost import Shard, save_bundle_multihost
    from instag_torch.parallel.tensor_parallel import \
        rasterize_tensor_parallel
    from instag_torch.train import pretrain as TP
    from instag_torch.train.common import replica_tensors

    fns = kernel_fns()
    launches = {fn.__name__: 0 for fn in fns}

    def count(run):
        """``run()``, its kernel launches added to this rank's count (the
        references computed beside it are not counted)."""
        for fn in fns:
            fn.launches = 0
        res = run()
        torch.cuda.synchronize()
        for fn in fns:
            launches[fn.__name__] += fn.launches
        return res

    out = {}
    # the dp=4 step at W = 2: this rank's 2 frames
    case = _dp_case(dev)
    loss, grads = count(lambda: _dp_grads(case, list(range(PAR_DP))[
        shard_rows(PAR_DP, group)], group))
    check_replicas(replica_tensors(case["state"].replace(
        params=G.GaussianParams(**{f: grads[f] for f in G.PARAM_FIELDS})),
        umf=case["nets"][0], pmf=case["nets"][1]), group)
    out["dp"] = (loss, {k: v.cpu() for k, v in grads.items()})
    del case, grads

    # one identity-parallel face motion step: this rank's identity
    run = TP._start(ModelConfig(source_path=ids_root, init_num=2000),
                    OptimizationConfig(), PRE_IDS, False, 0, False, 1000,
                    dev, "phase 18", only=rank)
    state, gopt = run["states"][rank], run["gopts"][rank]
    batch = run["batches"][rank]
    umf = init_motion_params(MotionNetwork(),
                             torch.Generator().manual_seed(0)).to(dev)
    pmfs = [init_motion_params(PersonalizedMotionNetwork("face"),
                               torch.Generator().manual_seed(1 + k)).to(dev)
            for k in range(len(PRE_IDS))]
    flags = TP.PretrainFlags(use_regs=1.0, hair_paint=0.0)
    base = copy.deepcopy((umf, pmfs))

    def motion(nets):
        u, ps = copy.deepcopy(nets)
        return TP.make_pretrain_face_step(
            run["cfg"], OptimizationConfig(), u, ps,
            copy.deepcopy(u).requires_grad_(False), run["extents"][0],
            run["select_iter"], run["iterations"], device=dev)
    serial = motion(base)(state, gopt, rank, batch, 0, 1, flags)[2]
    idp_motion = motion(base)
    idp = make_idp_pretrain_step(idp_motion, group)
    _, _, idp_loss = count(lambda: idp(state, gopt, batch, 0, 1, flags))
    check_replicas(TP.replica_tensors_of(idp_motion), group)
    path = os.path.join(ids_root, "phase18_idp.pkl")
    save_bundle_multihost(path, {
        "umf_params": flax_params(idp_motion.umf_net),
        "xyz": Shard(state.params.xyz[None].cpu()),
        "data_list": PRE_IDS}, group)
    if rank == 0:
        b = load_bundle(path)
        net = load_motion_net(MotionNetwork(), b["umf_params"], dev)
        same = all(torch.equal(a, c) for a, c in zip(
            net.state_dict().values(),
            idp_motion.umf_net.state_dict().values()))
        out["bundle"] = (tuple(b["xyz"].shape), same,
                         bundle_list(b["data_list"]))
    out["idp"] = (float(serial), float(idp_loss))
    del run, state, gopt, batch

    # one tensor-parallel frame, forward and backward, at W = 2
    cloud = synthetic_state(30000, 32768, seed=0, scale=0.004, device=dev)
    cam = synthetic_camera(SIZE, device=dev)
    cfg = RasterizeConfig(SIZE, SIZE, max_per_tile=256)
    bg = torch.tensor([0.1, 0.2, 0.3], device=dev)

    def args(rows):
        xyz = cloud.params.xyz[rows].detach().clone().requires_grad_(True)
        op = cloud.get_opacity()[rows].detach().clone().requires_grad_(True)
        return xyz, op, dict(
            scales=cloud.get_scaling()[rows].detach(),
            rotations=cloud.get_rotation()[rows].detach(),
            viewmatrix=cam.view_transform, projmatrix=cam.full_proj_transform,
            campos=cam.camera_center, tanfovx=cam.tanfovx,
            tanfovy=cam.tanfovy, bg=bg,
            shs=cloud.get_features()[rows].detach(), sh_degree=1,
            active=cloud.alive[rows])
    rows = shard_rows(cloud.capacity, group)
    xyz, op, kw = args(rows)

    def tensor_parallel():
        tp = rasterize_tensor_parallel(cfg, group, xyz, op, **kw)
        (tp.image.pow(2).sum() + tp.alpha.sum()).backward()
        return tp
    tp = count(tensor_parallel)
    fxyz, fop, fkw = args(slice(None))
    full = rasterize(cfg, fxyz, fop, **fkw)
    (full.image.pow(2).sum() + full.alpha.sum()).backward()
    band = SIZE // 2
    ys = slice(rank * band, (rank + 1) * band)
    out["tp"] = dict(
        image=float((tp.image - full.image[:, ys]).detach().abs().max()),
        alpha=float((tp.alpha - full.alpha[:, ys]).detach().abs().max()),
        radii=bool(torch.equal(tp.radii, full.radii[rows])),
        xyz=float((xyz.grad - fxyz.grad[rows]).abs().max()
                  / fxyz.grad.abs().max()),
        opacity=float((op.grad - fop.grad[rows]).abs().max()
                      / fop.grad.abs().max()))
    out["launches"] = launches
    return out


def parallel_paths(card: str, dev: torch.device, step_ms: float,
                   scene: str, ids_root: str) -> dict:
    """Phase 18: (a) --data_parallel 4 on one card in process, against
    four single-frame steps; (b) cli.train_face --data_parallel 4 on
    phase 16's scene; (c) 2 ranks sharing the card over gloo (the dp step
    at W = 2, an identity-parallel step on phase 14's identities with the
    multi-process bundle, a tensor-parallel frame); (d) one rank over
    NCCL. Returns each kernel's launches on these paths."""
    import tempfile

    from instag_torch.cli import train_face as train_face_cli
    from instag_torch.io.checkpoints import load_bundle
    from instag_torch.models import gaussians as G
    from instag_torch.parallel.launch import start
    from instag_torch.parallel.mesh import init_distributed, shutdown

    t_phase = time.perf_counter()
    fns = kernel_fns()
    launches = {fn.__name__: 0 for fn in fns}

    def count(run):
        for fn in fns:
            fn.launches = 0
        res = run()
        torch.cuda.synchronize()
        for fn in fns:
            launches[fn.__name__] += fn.launches
        return res, {fn.__name__: fn.launches for fn in fns}

    # (a) one dp=4 step against four single-frame steps
    case = _dp_case(dev)
    loss4, g4 = _dp_grads(case, list(range(PAR_DP)))
    single = case["step"](1)
    singles, mean = [], {}
    for i in range(PAR_DP):
        singles.append(single.loss_and_grads(case["state"], case["batch"], i,
                                             case["flags"]))
        grads = {f: getattr(singles[-1][2], f) for f in G.PARAM_FIELDS}
        for net in case["nets"]:
            for n, p in net.named_parameters():
                grads[f"{type(net).__name__}.{n}"] = p.grad
        for k, v in grads.items():
            mean[k] = mean.get(k, 0) + v / PAR_DP
    worst = max(check_close(f"dp=4 gradient {k}", g4[k], v, GRAD_RTOL,
                            GRAD_ATOL_FRAC) for k, v in mean.items())
    loss1 = [float(s[0]) for s in singles]
    stats = G.GaussianState(**{**vars(case["state"])})
    for s in singles:
        stats = G.add_densification_stats(stats, s[3], s[1].radii,
                                          s[1].radii > 0)
    check_close("dp=4 xyz_grad_accum", g4["xyz_grad_accum"],
                stats.xyz_grad_accum, 2e-4, 1e-6)
    if not (torch.equal(g4["denom"], stats.denom)
            and torch.equal(g4["max_radii2d"], stats.max_radii2d)):
        raise AssertionError("dp=4 statistics differ from the four steps'")
    if not abs(loss4 - np.mean(loss1)) <= 1e-5 * abs(np.mean(loss1)):
        raise AssertionError(f"dp=4 loss {loss4} != mean {np.mean(loss1)}")
    del singles, stats, mean
    step = case["step"](PAR_DP)
    gopt = G.adam_init(case["state"].params)
    (st, gopt, _), step_launch = count(lambda: step(
        case["state"], gopt, case["batch"], list(range(PAR_DP)), 1,
        case["flags"]))
    if any(v != PAR_DP for v in step_launch.values()):
        raise AssertionError(f"a dp=4 step launched {step_launch}, "
                             f"expected {PAR_DP} of each kernel")
    times = []
    for it in range(2, PAR_TIMED + 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, gopt, _ = step(st, gopt, case["batch"], list(range(PAR_DP)), it,
                           case["flags"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    dp_ms = statistics.median(times)
    log(f"[{card}] (a) --data_parallel {PAR_DP} on one card, phase 7's "
        f"cloud: loss {loss4:.6f} vs the mean of {PAR_DP} single-frame "
        f"steps {np.mean(loss1):.6f}; Gaussian, UMF and PMF gradients "
        f"within {worst:.3f} of phase 7's tolerance against their mean; "
        f"statistics equal their sum; launches {step_launch} "
        f"a step; {dp_ms:.3f} ms a dp={PAR_DP} step (median of {PAR_TIMED}) "
        f"against {PAR_DP} x phase 8's step = {PAR_DP * step_ms:.3f} ms")
    ref = (loss4, {k: v.detach().cpu() for k, v in g4.items()})
    del st, gopt, step, g4

    # (c) start the 2 ranks; their start-up overlaps (d)
    ranks = start(_parallel_rank, 2, (ids_root,),
                  device=(f"cuda:{dev.index or 0}" if dev.type == "cuda"
                          else "cpu"), backend="gloo", timeout=PAR_TIMEOUT)

    # (d) one rank over NCCL: the collectives of the multi-GPU path
    tmp = tempfile.TemporaryDirectory()
    group, ndev = init_distributed(dev.type, init_method=(
        f"file://{os.path.join(tmp.name, 'nccl')}"), rank=0, world_size=1)
    backend = torch.distributed.get_backend(group)
    case = _dp_case(dev)                     # (a) stepped its nets
    (nccl_loss, nccl_g), _ = count(lambda: _dp_grads(
        case, list(range(PAR_DP)), group))
    shutdown()
    if backend != ("nccl" if dev.type == "cuda" else "gloo") \
            or nccl_loss != loss4:
        raise AssertionError(f"NCCL rank: backend {backend}, loss "
                             f"{nccl_loss} != {loss4}")
    worst_nccl = _close_all("NCCL dp=4", nccl_g, {k: v.to(dev) for k, v in
                                                  ref[1].items()})
    log(f"[{card}] (d) one rank over NCCL (file rendezvous, {ndev}): dp="
        f"{PAR_DP} loss bit-equal to (a)'s; gradients and statistics within "
        f"{worst_nccl:.3f} of rtol {DP_RTOL}, atol {DP_ATOL_FRAC} of scale "
        f"(the scatter's atomics add in another order each run)")
    del case, nccl_g

    # (c) the 2 ranks' results
    t_join = time.perf_counter()
    outs = ranks.join()
    for r, o in enumerate(outs):
        for k, v in o["launches"].items():
            launches[k] += v
        loss, g = o["dp"]
        if not abs(loss - ref[0]) <= 1e-6 * abs(ref[0]):
            raise AssertionError(f"rank {r}: dp=4 loss {loss} != {ref[0]}")
        worst_w2 = _close_all(f"rank {r} dp=4", g, ref[1])
        serial, idp = o["idp"]
        if not abs(serial - idp) <= 1e-6 * abs(serial):
            raise AssertionError(f"rank {r}: identity-parallel loss {idp} "
                                 f"!= serial {serial}")
        tp = o["tp"]
        if not (tp["image"] <= TP_ATOL["image"]
                and tp["alpha"] <= TP_ATOL["alpha"] and tp["radii"]
                and max(tp["xyz"], tp["opacity"]) <= TP_GRAD_ATOL):
            raise AssertionError(f"rank {r}: tensor-parallel frame {tp}")
    shape, same, names = outs[0]["bundle"]
    if not (shape[0] == 2 and same and names == PRE_IDS):
        raise AssertionError(f"the multi-process bundle: {shape}, UMF equal "
                             f"{same}, {names}")
    log(f"[{card}] (c) 2 ranks sharing the card over gloo (joined "
        f"{time.perf_counter() - t_join:.1f} s after (d)): dp={PAR_DP} at "
        f"W=2 within {worst_w2:.3f} of (a)'s tolerance, replicas "
        f"bit-identical; identity-parallel face step losses "
        f"{[round(o['idp'][1], 6) for o in outs]} equal the serial steps', "
        f"UMF bit-identical, rank 0's bundle read back (xyz {shape}); "
        f"tensor-parallel 512x512 frame: bands within "
        f"{max(o['tp']['image'] for o in outs):.2e} (image), radii equal, "
        f"gradients within "
        f"{max(max(o['tp']['xyz'], o['tp']['opacity']) for o in outs):.2e} "
        f"of scale; launches {[o['launches'] for o in outs]}")

    # (b) cli.train_face --data_parallel 4 on phase 16's scene
    run_dir = os.path.join(tmp.name, "run")
    argv = ["-s", scene, "-m", run_dir, "--iterations", str(PAR_CLI_ITERS),
            "--data_parallel", str(PAR_DP), "--device", dev.type]
    (res, _, cli_s, cli_launch) = _in_process(train_face_cli.main, argv)
    for k, v in cli_launch.items():
        launches[k] += v
    with open(os.path.join(ROOT, BUNDLE_KEYS)) as f:
        want = json.load(f)["face"]
    bundle = load_bundle(os.path.join(run_dir, "chkpnt_face_latest.pkl"))
    losses = np.array(res["losses"])
    if not (len(losses) == PAR_CLI_ITERS and np.isfinite(losses).all()
            and _key_paths(bundle) == want):
        raise AssertionError("cli.train_face --data_parallel: losses or "
                             "bundle malformed")
    log(f"[{card}] (b) cli.train_face --data_parallel {PAR_DP} on phase "
        f"16's scene: {PAR_CLI_ITERS} steps in {cli_s:.2f} s through main "
        f"(scene read and val report included), "
        f"{cli_s * 1e3 / PAR_CLI_ITERS:.1f} ms a step; bundle keys as "
        f"the manifest's; launches {cli_launch}")
    tmp.cleanup()
    log(f"[{card}] phase 18: {time.perf_counter() - t_phase:.1f} s; "
        f"launches {launches}")
    return launches


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
    from instag_torch.ops.composite import (composite_bwd, composite_fwd,
                                            composite_fwd_plain)
    from instag_torch.ops.rasterize import (RasterizeConfig, prepare,
                                            sh_colors, tile_features)
    from instag_torch.ops.scatter import scatter_add_tiles
    from instag_torch.train.face import (Flags, make_face_block,
                                         make_face_step)
    from instag_torch.render import _masked_features
    from instag_torch.synthesize import (SynthesisModel, make_synthesis_fn,
                                         synthesize_frame)

    t_start = time.perf_counter()

    def mark(phase):
        log(f"[t={time.perf_counter() - t_start:.1f} s] phase {phase}")

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

    # ---- 2. build, beside phases 16 and 17 -------------------------------
    # The splat kernels take minutes to compile, and the preprocessing chain
    # and the photometric fit need only the JPEG codec until phase 16's
    # training run: they run first, while nvcc compiles the rest.
    t0 = time.perf_counter()
    built = kernels.build(["jpeg_codec"])
    compiling = concurrent.futures.ThreadPoolExecutor(1).submit(
        lambda: (kernels.build(SOURCES), time.perf_counter() - t0))

    mark(16)
    # ---- 16. the preprocessing chain, and before its training run (which
    # needs the kernels) 17. the photometric fit and the learned extractors
    def before_training(capture):
        photometric_and_extractors(card, dev, capture)
        per_source, wall = compiling.result()
        times = {k: round(v, 1) for k, v in {**built, **per_source}.items()}
        log(f"build: {wall:.1f} s wall (beside phases 16-17); per source "
            f"{times} (0 entries: cached)")
        for src in SOURCES:
            with open(kernels.library_path(src) + ".log") as f:
                for line in f:
                    if "registers" in line or "spill" in line:
                        log(f"  ptxas {src}:", line.strip())
    seam = preprocessing_seam(card, dev, before_training)

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

    mark(3)
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
            pairs, worst = fwd_check("face cloud", feats, cnt, cfg.tiles_x,
                                     n_chan, n_aux)
            cases[(n_chan, n_aux)] = (feats, cnt, pairs, worst)

        # the training shape's kernels (C=8, A=2, and the backward without
        # aux), on the face cloud and on a cloud that covers the frame
        gen = torch.Generator(dev).manual_seed(11)
        ids = prep.ids.contiguous()
        n_splats = face.capacity
        train_cases = {}
        for n_aux in (2, 0):
            feats, cnt = tile_features(
                prep.px, prep.py, prep.proj, opac, colors,
                torch.ones_like(opac), prep.ids, prep.valid,
                aux_colors=aux[:, :n_aux] if n_aux else None)
            g = torch.randn((feats.shape[1], 10 + n_aux, 256), device=dev,
                            generator=gen)
            train_cases[("face", n_aux)] = training_kernel_checks(
                "face cloud", feats, cnt, g, ids, n_splats, cfg.tiles_x,
                n_aux)
        wide = synthetic_state(30000, 32768, seed=2, spread=WIDE_SPREAD,
                               scale=WIDE_SCALE, device=dev)
        w_prep = prepare(cfg, wide.params.xyz, wide.get_scaling(),
                         wide.get_rotation(), cam.view_transform,
                         cam.full_proj_transform, cam.camera_center,
                         cam.tanfovx, cam.tanfovy, active=wide.alive)
        w_colors = sh_colors(wide.params.xyz, cam.camera_center,
                             _masked_features(wide), wide.max_sh_degree)
        w_opac = wide.get_opacity().reshape(-1)
        feats, cnt = tile_features(
            w_prep.px, w_prep.py, w_prep.proj, w_opac, w_colors,
            torch.ones_like(w_opac), w_prep.ids, w_prep.valid,
            aux_colors=aux[:, :2])
        busy = int((cnt > 0).sum())
        log(f"wide cloud: 30000/32768 splats, seed 2, spread {WIDE_SPREAD}, "
            f"scale {WIDE_SCALE}: {busy} of {cnt.numel()} tiles busy, "
            f"sum cnt {int(cnt.sum())}, {int((cnt == 256).sum())} tiles "
            f"at K")
        if busy < 0.8 * cnt.numel():
            raise AssertionError(f"wide cloud covers {busy} tiles, < 80 %")
        g = torch.randn((feats.shape[1], 12, 256), device=dev, generator=gen)
        w_ids = w_prep.ids.contiguous()
        train_cases[("wide", 2)] = training_kernel_checks(
            "wide cloud", feats, cnt, g, w_ids, wide.capacity, cfg.tiles_x, 2)
        # the serving shape where a real face puts it: every tile busy
        feats, cnt = tile_features(
            w_prep.px, w_prep.py, w_prep.proj, w_opac, w_colors,
            torch.ones_like(w_opac), w_prep.ids, w_prep.valid)
        pairs, worst = fwd_check("wide cloud", feats, cnt, cfg.tiles_x, 8, 0)
        cases["wide", 8, 0] = (feats, cnt, pairs, worst)

    mark(4)
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

    mark(5)
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
    wf, wc, w_pairs, err_wide = cases["wide", 8, 0]
    kw_ms = cuda_ms(lambda: composite_fwd(wf, wc, cfg.tiles_x, 8, 0))
    pw_ms = cuda_ms(lambda: composite_fwd_plain(wf, wc, cfg.tiles_x, 8, 0),
                    reps=2, rounds=5, warmup=1)
    bw_ms, bw_by = kernel_bound(wf, wc, 8, 0, w_pairs)
    wide_serving = dict(ms=kw_ms, plain_ms=pw_ms, bound_ms=bw_ms,
                        bound_by=bw_by, library_ms=None, max_abs_err=err_wide)
    log(f"[{card}] wide cloud composite_fwd C=8 A=0 T=1024 K=256: kernel "
        f"{kw_ms:.4f} ms, plain {pw_ms:.3f} ms, bound {bw_ms:.4f} ms "
        f"({bw_by}), kernel at {bw_ms / kw_ms:.1%} of bound")
    f34, c34, pairs34, err34 = cases[(3, 4)]
    k34 = cuda_ms(lambda: composite_fwd(f34, c34, cfg.tiles_x, 3, 4))
    log(f"[{card}] composite_fwd C=3 A=4: kernel {k34:.4f} ms")

    mark(6)
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

    mark(7)
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

    mark(8)
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

    timed = {
        "face": time_training_kernels("face cloud", card,
                                      train_cases[("face", 2)], ids,
                                      prep.valid, n_splats, cfg.tiles_x),
        "wide": time_training_kernels("wide cloud", card,
                                      train_cases[("wide", 2)], w_ids,
                                      w_prep.valid, wide.capacity,
                                      cfg.tiles_x)}
    bwd_lib = kernels.load("composite_bwd").composite_bwd_shared_bytes
    bwd_lib.restype = ctypes.c_longlong
    log(f"composite_bwd dynamic shared memory per CTA at K=256, T=1024, "
        f"C+A=10: {bwd_lib(256, 1024, 10)} bytes")

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

    mark(9)
    # ---- 9. the adaptation loop at full width -----------------------------
    loop_launches, face_res, loop_batch, loop_meta, loop_nets = \
        adaptation_loop(card, dev, SIZE)

    mark(10)
    # ---- 10. the mouth loop at full width ----------------------------------
    mouth_launches, mouth_res = mouth_loop(card, dev, face_res, loop_batch,
                                           loop_meta, loop_nets)

    mark(11)
    # ---- 11. the fusion loop at full width ---------------------------------
    lpips_face_step(card, dev)
    fuse_launches, fuse_res = fuse_loop(card, dev, face_res, mouth_res,
                                        loop_batch)
    later = {"mouth_loop": mouth_launches, "fuse_loop": fuse_launches}

    mark(12)
    # ---- 12. clip synthesis through the CLI --------------------------------
    clip = clip_synthesis(card, dev, fuse_res)

    mark(13)
    # ---- 13. the adaptation CLIs --------------------------------------------
    clis = adaptation_clis(card, dev, clip["scene"], clip["tmp"].name)
    clip["tmp"].cleanup()
    later["adaptation_clis"] = clis["all"]

    mark(14)
    # ---- 19. the workflow scripts, beside phases 14 and 15 -------------------
    scripts = workflow_scripts_start(dev)
    # ---- 14. multi-identity pre-training ------------------------------------
    kept = []
    # phase 15's scene and CLI start beside phase 14's CLI process
    pre, hard = pretraining(card, dev, kept,
                            beside=lambda: static_scene(card, dev))
    later.update(pre)

    mark(15)
    # ---- 15. static training and reference import ---------------------------
    static = static_training(card, dev, hard)
    later["static_training"] = static["launches"]
    static_t = static["timed"]

    mark(19)
    later["workflow_scripts"] = workflow_scripts(card, scripts)

    mark(18)
    # ---- 18. the parallel modes -------------------------------------------
    later["parallel"] = parallel_paths(card, dev, step_ms, seam["base"],
                                       kept[0][1])
    seam["tmp"].cleanup()
    kept[0][0].cleanup()
    mark("end")

    later["preprocessing_seam"] = seam["launches"]

    face_t, wide_t = timed["face"], timed["wide"]
    bwd_err = max(c["bwd_err"] for c in train_cases.values())
    log(json.dumps({"kernels": [{
        "name": "composite_fwd", "route": "cuda",
        "source": "instag_torch/csrc/composite_fwd.cu",
        "replaces": "instag_tpu/ops/pallas_composite.py:190",
        "launches": (launches + train_launches["composite_fwd"]
                     + loop_launches["composite_fwd"]
                     + sum(v["composite_fwd"] for v in later.values())
                     + clip["launches"]),
        "launches_by_path": {"serving": launches,
                             "training": train_launches["composite_fwd"],
                             "adaptation_loop":
                                 loop_launches["composite_fwd"],
                             **{k: v["composite_fwd"]
                                for k, v in later.items()},
                             "clip_synthesis": clip["launches"]},
        "max_abs_err": max(err_main, err34, err_wide,
                           *(c["fwd_err"] for c in train_cases.values()),
                           static_t["composite_fwd"]["max_abs_err"]),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "wide_serving": wide_serving,
        "training_shape": {"face": face_t["composite_fwd"],
                           "wide": wide_t["composite_fwd"],
                           "static": static_t["composite_fwd"]}}, {
        "name": "composite_bwd", "route": "cuda",
        "source": "instag_torch/csrc/composite_bwd.cu",
        "replaces": "instag_tpu/ops/pallas_composite.py:260",
        "launches": (train_launches["composite_bwd"]
                     + loop_launches["composite_bwd"]
                     + sum(v["composite_bwd"] for v in later.values())),
        "launches_by_path": {"training": train_launches["composite_bwd"],
                             "adaptation_loop":
                                 loop_launches["composite_bwd"],
                             **{k: v["composite_bwd"]
                                for k, v in later.items()}},
        **{k: face_t["composite_bwd"][k] for k in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "max_abs_err": max(bwd_err,
                           static_t["composite_bwd"]["max_abs_err"]),
        "wide": wide_t["composite_bwd"],
        "static": static_t["composite_bwd"]}, {
        "name": "scatter_add", "route": "cuda",
        "source": "instag_torch/csrc/scatter_add.cu",
        "replaces": "instag_tpu/ops/pallas_scatter.py:53",
        "launches": (train_launches["scatter_add_tiles"]
                     + loop_launches["scatter_add_tiles"]
                     + sum(v["scatter_add_tiles"] for v in later.values())),
        "launches_by_path": {"training": train_launches["scatter_add_tiles"],
                             "adaptation_loop":
                                 loop_launches["scatter_add_tiles"],
                             **{k: v["scatter_add_tiles"]
                                for k, v in later.items()}},
        **{k: face_t["scatter_add"][k] for k in
           ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "max_abs_err": max(face_t["scatter_add"]["max_abs_err"],
                           wide_t["scatter_add"]["max_abs_err"],
                           static_t["scatter_add"]["max_abs_err"]),
        "wide": wide_t["scatter_add"],
        "static": static_t["scatter_add"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
