"""Clip streams: each client renders its own identity's clip in a closed
loop through the program's serving path,
``instag_torch.synthesize.make_synthesis_chunk_fn(cfg, dilate=True)`` in
chunks of the program's ``DISPATCH_CHUNK`` frames, and copies its uint8
frames to the host every ``FETCH_WINDOW`` frames, as
``synthesize.synthesize`` does (a traffic mix may set a ``fetch_window``
of its own). A frame counts when the card has finished its chunk inside
the window (a CUDA event after each chunk), so the count does not move in
lumps of a fetch window.

``correct``: a sample of each client's delivered frames, drawn from the
seed, against the plain reference's frames from the same inputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import gen, reference

RATE_METRIC = "clip_fps"
UNIT = "frames"
NETS = ("face_umf", "mouth_umf", "face_pmf", "mouth_pmf")


def inputs(cfg: dict, traffic: dict, seed: int, index: int, dev) -> dict:
    """Client ``index``'s identity (both clouds, the four nets' weights)
    and its track (cameras, audio windows, AU vectors, torso), from the
    seed, on ``dev``."""
    g = gen.generator(gen.sub_seed(seed, index, 1), dev)
    model = {}
    for branch in ("face", "mouth"):
        b = cfg[branch]
        model[branch] = gen.cloud(g, b["live"], b["capacity"],
                                  b["sh_degree"], b["center"],
                                  b["half_axes"], b["scale_range"],
                                  b["opacity_range"], dev)
    for net in NETS:
        model[net] = gen.net_params(
            reference.net_shapes(net, cfg["audio_extractor"]), g, dev,
            cfg["nets"]["embed_bound"], cfg["nets"]["bias_bound"])
    n = traffic["frames"]
    cam = gen.camera_track(np.random.default_rng(gen.sub_seed(seed, index, 2)),
                           n, cfg["image_size"], cfg["camera"]["focal"],
                           cfg["camera"]["distance"], cfg["camera"]["pose_amp"])
    t = {k: torch.from_numpy(v).to(dev) for k, v in cam.items()
         if k != "tan"}
    t["tan"] = torch.tensor(cam["tan"], device=dev)
    t["aud"] = gen.audio_track(g, n, cfg["audio_window"], dev)
    t["au"] = gen.au_track(g, n, dev)
    t["torso"] = gen.torso(g, cfg["image_size"], dev)
    return dict(model=model, track=t)


def sh_degrees(cfg: dict) -> tuple:
    """The face's and the mouth's SH degrees."""
    return cfg["face"]["sh_degree"], cfg["mouth"]["sh_degree"]


def frame_camera(track: dict, i: int) -> dict:
    return dict(view=track["view"][i], full=track["full"][i],
                center=track["center"][i], tan=track["tan"])


def program_objects(cfg: dict, traffic: dict, data: dict, dev):
    """The program's model, frame batch and chunk function over ``data``."""
    from instag_torch.models.gaussians import GaussianParams, GaussianState
    from instag_torch.models.motion import (MotionNetwork,
                                            MouthMotionNetwork,
                                            PersonalizedMotionNetwork)
    from instag_torch.ops.rasterize import RasterizeConfig
    from instag_torch.synthesize import (SynthesisModel,
                                         make_synthesis_chunk_fn)
    from instag_torch.train.common import FrameBatch

    ext, m, t = cfg["audio_extractor"], data["model"], data["track"]

    def state(branch):
        raw, deg = m[branch], cfg[branch]["sh_degree"]
        fields = {k: raw[k] for k in ("xyz", "features_dc", "features_rest",
                                      "identity", "scaling", "rotation",
                                      "opacity")}
        return GaussianState(params=GaussianParams(**fields),
                             alive=raw["alive"], active_sh_degree=deg,
                             max_sh_degree=deg)
    nets = dict(face_umf=MotionNetwork(ext), mouth_umf=MouthMotionNetwork(ext),
                face_pmf=PersonalizedMotionNetwork("face", ext),
                mouth_pmf=PersonalizedMotionNetwork("mouth", ext))
    for k, net in nets.items():
        net.to(dev).load_state_dict(m[k], strict=True)
        net.eval()
    model = SynthesisModel(state("face"), state("mouth"),
                           nets["face_umf"], nets["mouth_umf"],
                           nets["face_pmf"], nets["mouth_pmf"])
    n, size = traffic["frames"], cfg["image_size"]
    torso = t["torso"][None].expand(n, size, size, 3)
    zeros = torch.zeros((1, size, size), dtype=torch.bool, device=dev)
    rect = torch.zeros((n, 4), dtype=torch.int32, device=dev)
    batch = FrameBatch(
        view_transform=t["view"], full_proj_transform=t["full"],
        camera_center=t["center"], tanfovx=t["tan"].expand(n),
        tanfovy=t["tan"].expand(n), image=torso, bg=torso,
        face_mask=zeros.expand(n, -1, -1), hair_mask=zeros.expand(n, -1, -1),
        mouth_mask=zeros.expand(n, -1, -1), auds=t["aud"],
        blink=t["au"][:, 5], au_exp=t["au"], lips_rect=rect,
        lhalf_rect=rect, mouth_bound=torch.zeros((n, 3), device=dev))
    rcfg = RasterizeConfig(size, size, max_per_tile=cfg["max_per_tile"])
    fn = make_synthesis_chunk_fn(rcfg, dilate=traffic["dilate"],
                                 device=dev)
    return model, batch, fn


def windows(traffic: dict) -> tuple:
    """Frames a dispatch (the program's ``synthesize.DISPATCH_CHUNK``) and
    frames a fetch (the traffic's, or else ``synthesize.FETCH_WINDOW``)."""
    from instag_torch import synthesize
    return (synthesize.DISPATCH_CHUNK,
            traffic.get("fetch_window", synthesize.FETCH_WINDOW))


class Client:
    """One clip stream: set up from the seed, warmed, then run in the
    window; it keeps the latest delivered copy of each of its frames."""

    def __init__(self, cell: dict, seed: int, index: int, dev):
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.index, self.dev = seed, index, dev
        data = inputs(self.cfg, self.traffic, seed, index, dev)
        self.model, self.batch, self.fn = program_objects(
            self.cfg, self.traffic, data, dev)
        s = cell["clients"]
        self.n = self.traffic["frames"]
        self.chunk, self.fetch = windows(self.traffic)
        # the clients start at other frames of their tracks and fetch at
        # other phases, as independent streams do
        self.pos = index * self.n // s
        self.phase = (index * self.fetch // s) // self.chunk * self.chunk
        self.last: dict[int, tuple] = {}
        self.trace_frames = 0
        self.rec = None             # a trace.Recorder in a traced run

    def _chunk(self):
        ivec = [(self.pos + j) % self.n for j in range(self.chunk)]
        self.pos += self.chunk
        return ivec, self.fn(self.model, self.batch, ivec)

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def warm(self) -> None:
        """One whole fetch window: every shape the window uses."""
        pending = [self._chunk() for _ in range(self.fetch // self.chunk)]
        torch.cat([p for _, p in pending]).cpu()
        if self.rec is not None:
            self.rec.prime()

    def run(self, t0: float, t_end: float) -> dict:
        tr, rec, cuda = self.traffic, self.rec, self.dev.type == "cuda"
        pending, pend_n, target = [], 0, self.fetch - self.phase
        done, marks = [], []            # frames of each chunk, its event
        while time.monotonic() < t0:
            time.sleep(0.0005)
        if cuda:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        while time.monotonic() < t_end:
            if rec is not None:
                # the span starts and ends synchronised, so its frames'
                # device work all falls inside it
                now = time.monotonic()
                if rec.prof is None and now >= t0 + tr["trace_lead_s"]:
                    self._sync()
                    rec.start()
                elif rec.on and rec.may_stop(tr["trace_s"]):
                    self._sync()
                    rec.stop()
            ivec, imgs = self._chunk()
            done.append(len(ivec))
            if cuda:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks.append(ev)
            if rec is not None and rec.on:
                self.trace_frames += len(ivec)
            pending.append((ivec, imgs))
            pend_n += len(ivec)
            if pend_n < target:
                continue
            host = torch.cat([p for _, p in pending]).cpu().numpy()
            row = 0
            for ivec, _ in pending:
                for i in ivec:
                    self.last[i] = (host, row)
                    row += 1
            pending, pend_n, target = [], 0, self.fetch
        self._sync()
        if rec is not None and rec.on:
            raise RuntimeError("the window closed before the traced span: "
                               "lengthen the window or shorten the span")
        if cuda:
            limit = (t_end - t0) * 1e3
            done = [n for n, ev in zip(done, marks)
                    if ev0.elapsed_time(ev) <= limit]
        frames = sum(done)
        return dict(units=frames, attempted=frames,
                    trace_units=self.trace_frames)

    def finish(self, path: str) -> None:
        """Write the sample of delivered frames that ``correct`` judges."""
        rng = np.random.default_rng(gen.sub_seed(self.seed, self.index, 3))
        have = np.array(sorted(self.last), np.int64)
        k = min(self.traffic["samples_per_client"], len(have))
        idx = np.sort(rng.choice(have, k, replace=False)) if k else have
        frames = np.stack([self.last[i][0][self.last[i][1]] for i in idx]) \
            if k else np.zeros((0,), np.uint8)
        np.savez(path, idx=idx, frames=frames)


def _reference_frames(cfg, traffic, data, idx, tf32: bool):
    out, counts = [], []
    t = data["track"]
    with torch.inference_mode(), reference.precision(tf32):
        for i in idx:
            u8, c = reference.frame(
                data["model"], frame_camera(t, int(i)), t["aud"][i],
                t["au"][i], t["torso"], cfg["image_size"],
                cfg["max_per_tile"], sh_degrees(cfg), traffic["dilate"])
            out.append(u8.cpu().numpy())
            counts.append(c)
    return out, counts


def compare(got: np.ndarray, ref: np.ndarray) -> dict:
    """Per frame: the share of the frame's values that differ from the
    reference's, and the largest difference in levels."""
    d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    return dict(diff_share=float((d > 0).mean()), max_level=int(d.max()))


def check(cell: dict, seed: int, samples: list, dev, tf32: bool = False):
    """Judge each client's sampled frames (``samples``: per client the
    ``idx`` and ``frames`` its run wrote) against the reference in full
    float32. With ``tf32`` the reference in TF32 takes the program's
    place (the control), on the same frames. Returns the worst numbers
    and the reference's mean composite counts of a frame."""
    cfg, traffic = cell["config"], cell["traffic"]
    worst = dict(diff_share=0.0, max_level=0)
    counts, n = [], 0
    for index, smp in enumerate(samples):
        data = inputs(cfg, traffic, seed, index, dev)
        idx = smp["idx"]
        if len(idx) == 0:           # a stream that delivered nothing
            worst["diff_share"] = 1.0
            continue
        ref, c = _reference_frames(cfg, traffic, data, idx, False)
        got = smp["frames"] if not tf32 else np.stack(
            _reference_frames(cfg, traffic, data, idx, True)[0])
        for g, r in zip(got, ref):
            cmp = compare(g, r)
            worst = {k: max(worst[k], cmp[k]) for k in worst}
            n += 1
        counts += c
        del data
    mean = {b: {k: float(np.mean([c[b][k] for c in counts]))
                for k in counts[0][b]} for b in ("face", "mouth")} \
        if counts else {}
    return dict(numbers=dict(worst, frames=n), counts=mean)


def control_samples(cell: dict, seed: int) -> list:
    """The frames a control run judges: per client, a sample of its track
    drawn from the seed (no window runs)."""
    out = []
    for index in range(cell["clients"]):
        rng = np.random.default_rng(gen.sub_seed(seed, index, 3))
        k = cell["traffic"]["samples_per_client"]
        out.append(dict(idx=np.sort(rng.choice(cell["traffic"]["frames"], k,
                                               replace=False))))
    return out
