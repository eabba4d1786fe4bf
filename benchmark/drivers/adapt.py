"""Adaptation jobs: each client adapts its own identity through the
program's loop, ``instag_torch.train.face.train_face``, from iteration 1
with a pretrained-UMF stand-in made from the seed, on frames resident on
the device. The loop's own step object is wrapped (counting, tracing,
pausing at the end of set-up, and ending the loop at the window's close);
nothing of the program changes. A step counts when the card has finished
it inside the window (a CUDA event after each step).

The phase is pinned whatever the program's speed: a job that reaches the
traffic's ``last_iteration`` (at most the program's ``densify_from_iter``)
ends there, and the client starts the next job from iteration 1 with the
same starting weights, as a queue of adaptation jobs does, so the window
never reaches densification.

``correct``: the first ``compare_steps`` steps of each job, which set-up
drives through the same call, against the plain reference's
(``reference_train.py``): each step's loss, each leaf's first gradient as
its optimizer holds it, and each leaf's change after the steps.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import torch

from .. import gen, reference, reference_train

RATE_METRIC = "adapt_steps_per_s"
UNIT = "steps"


class WindowClosed(Exception):
    """Raised from the step wrapper to end the loop at the window's close."""


class JobDone(Exception):
    """Raised from the step wrapper to end a job at ``last_iteration``."""


def job_seed(seed: int, index: int) -> int:
    return gen.sub_seed(seed, index, 4) % (2 ** 31)


def inputs(cfg: dict, traffic: dict, seed: int, index: int, dev) -> dict:
    """Job ``index``'s frames, cameras, audio and AU track, and its
    pretrained-UMF and PMF weights, from the seed, on ``dev``."""
    g = gen.generator(gen.sub_seed(seed, index, 1), dev)
    rng = np.random.default_rng(gen.sub_seed(seed, index, 2))
    n, size = traffic["frames"], cfg["image_size"]
    nets = {k: gen.net_params(reference.net_shapes(k, cfg["audio_extractor"]),
                              g, dev, cfg["nets"]["embed_bound"],
                              cfg["nets"]["bias_bound"])
            for k in ("face_umf", "face_pmf")}
    cam = gen.camera_track(rng, n, size, cfg["camera"]["focal"],
                           cfg["camera"]["distance"], cfg["camera"]["pose_amp"])
    fr = gen.talking_frames(g, rng, n, size, dev)
    fr["aud"] = gen.audio_track(g, n, cfg["audio_window"], dev)
    fr.update({k: torch.from_numpy(v).to(dev) for k, v in cam.items()
               if k != "tan"})
    fr["tan"] = torch.tensor(cam["tan"], device=dev)
    return dict(nets=nets, frames=fr, centers=cam["center"])


OPT_KEYS = ("position_lr_init", "position_lr_final", "position_lr_max_steps",
            "feature_lr", "opacity_lr", "scaling_lr", "rotation_lr",
            "identity_lr")


def configs(cfg: dict, traffic: dict):
    from instag_torch.config import ModelConfig, OptimizationConfig
    mc = ModelConfig(sh_degree=cfg["face"]["sh_degree"],
                     init_num=cfg["init_num"], N_views=traffic["frames"],
                     audio_extractor=cfg["audio_extractor"],
                     capacity=cfg["capacity"],
                     max_per_tile=cfg["max_per_tile"])
    oc = OptimizationConfig(iterations=cfg["iterations"],
                            densify_grad_threshold=cfg[
                                "densify_grad_threshold"])
    return mc, oc


class Client:
    def __init__(self, cell: dict, seed: int, index: int, dev):
        from instag_torch.models.motion import (MotionNetwork,
                                                PersonalizedMotionNetwork)
        from instag_torch.train.common import FrameBatch, FrameMeta
        self.cfg, self.traffic = cell["config"], cell["traffic"]
        self.seed, self.index, self.dev = seed, index, dev
        d = inputs(self.cfg, self.traffic, seed, index, dev)
        f, n = d["frames"], self.traffic["frames"]
        self.batch = FrameBatch(
            view_transform=f["view"], full_proj_transform=f["full"],
            camera_center=f["center"], tanfovx=f["tan"].expand(n),
            tanfovy=f["tan"].expand(n), image=f["image"], bg=f["bg"],
            face_mask=f["face_mask"], hair_mask=f["hair_mask"],
            mouth_mask=f["mouth_mask"], auds=f["aud"], blink=f["blink"],
            au_exp=f["au_exp"], lips_rect=f["lips_rect"],
            lhalf_rect=f["lhalf_rect"], mouth_bound=f["mouth_bound"])
        m = f["meta"]
        au25, pcts = FrameMeta.au25_stats(m["au25_raw"])
        self.meta = FrameMeta(blink=m["blink"], mouth=m["mouth"],
                              mouth_lb=m["mouth_lb"], mouth_ub=m["mouth_ub"],
                              au25=au25, au25_pcts=pcts,
                              mouth_px=m["mouth_px"])
        ext = self.cfg["audio_extractor"]
        self.umf = MotionNetwork(ext).to(dev)
        self.umf.load_state_dict(d["nets"]["face_umf"], strict=True)
        self.pmf = PersonalizedMotionNetwork("face", ext).to(dev)
        self.pmf.load_state_dict(d["nets"]["face_pmf"], strict=True)
        self.mc, self.oc = configs(self.cfg, self.traffic)
        if self.traffic["last_iteration"] > self.oc.densify_from_iter:
            raise ValueError("last_iteration lies past the program's "
                             "densify_from_iter: the phase would change")
        self.start_nets = {k: {n: v.detach().clone() for n, v in
                               net.state_dict().items()}
                           for k, net in (("umf", self.umf),
                                          ("pmf", self.pmf))}
        self.jobs = 0
        self.marks = [("inputs", time.monotonic())]
        self.count = 0
        self.record = dict(losses=[], frames=[], grads={}, changes={})
        self.warmed = threading.Event()
        self.go = threading.Event()
        self.t0 = self.t_end = None
        self.rec = None             # a trace.Recorder in a traced run
        self.events = []
        self.trace_units = 0
        self.error = None

    # ---------------------------------------------------------- the probe
    def _leaves(self, state):
        out = {f"gaussians.{n}": getattr(state.params, n)
               for n in reference_train.FIELDS}
        out.update({f"umf.{n}": p for n, p in self.umf.named_parameters()})
        out.update({f"pmf.{n}": p for n, p in self.pmf.named_parameters()})
        return out

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def probe(self, inner):
        tr = self.traffic
        n_cmp, warm = tr["compare_steps"], tr["warm_steps"]

        def step(state, gopt, batch, i, it, flags, p=0):
            k = self.count
            if k == 0:
                self.marks.append(("loop", time.monotonic()))
                self.start = {n: v.detach().clone()
                              for n, v in self._leaves(state).items()}
            if self.t0 is not None:
                now = time.monotonic()
                if now >= self.t_end:
                    raise WindowClosed
                if self.rec is not None:
                    # the span starts and ends at synchronised step
                    # boundaries, so its steps' device work falls inside
                    if self.rec.prof is None \
                            and now >= self.t0 + tr["trace_lead_s"]:
                        self._sync()
                        self.rec.start()
                        self.trace_from = k
                    elif self.rec.on and self.rec.may_stop(tr["trace_s"]):
                        self._sync()
                        self.rec.stop()
                        self.trace_units = k - self.trace_from
            if it > tr["last_iteration"]:
                raise JobDone
            state, gopt, loss = inner(state, gopt, batch, i, it, flags, p)
            if k < n_cmp:
                self.record["losses"].append(loss.detach())
                self.record["frames"].append(int(i))
            if k == 0:
                g = {f"gaussians.{n}": getattr(gopt.mu, n).norm() / 0.1
                     for n in reference_train.FIELDS}
                for tag, opt, net in (("umf", inner.umf_opt, self.umf),
                                      ("pmf", inner.pmf_opt, self.pmf)):
                    for n, prm in net.named_parameters():
                        g[f"{tag}.{n}"] = opt.state[prm]["exp_avg"].norm() / 0.1
                self.record["grads"] = g
            if k == n_cmp - 1:
                self.record["changes"] = {
                    n: (v.detach() - self.start[n]).norm()
                    for n, v in self._leaves(state).items()}
            self.count = k + 1
            if self.t0 is not None and self.dev.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.events.append(ev)
            if self.count == max(warm, n_cmp):
                if self.rec is not None:
                    self.rec.prime()
                self._sync()
                self.marks.append(("warm", time.monotonic()))
                self.warmed.set()
                self.go.wait()
                if self.dev.type == "cuda":
                    self.ev0 = torch.cuda.Event(enable_timing=True)
                    self.ev0.record()
            return state, gopt, loss
        return step

    def _job(self):
        import instag_torch.train.face as face
        make = face.make_face_step

        def wrapped(*a, **kw):
            return self.probe(make(*a, **kw))
        face.make_face_step = wrapped
        try:
            while True:
                if self.jobs:
                    for k, net in (("umf", self.umf), ("pmf", self.pmf)):
                        net.load_state_dict(self.start_nets[k])
                self.jobs += 1
                try:
                    face.train_face(
                        self.mc, self.oc, self.batch, self.meta,
                        umf_net=self.umf, pmf_net=self.pmf, long=False,
                        log_every=10 ** 9,
                        seed=job_seed(self.seed, self.index),
                        lpips_enabled=False, device=self.dev)
                    self.error = RuntimeError("the loop ended before the "
                                              "window did")
                    return
                except JobDone:
                    continue
        except WindowClosed:
            pass
        except BaseException as e:
            self.error = e
        finally:
            face.make_face_step = make
            self.warmed.set()

    def warm(self) -> None:
        self.thread = threading.Thread(target=self._job, daemon=True)
        self.thread.start()
        self.warmed.wait()
        if self.error is not None:
            raise self.error

    def run(self, t0: float, t_end: float) -> dict:
        self.t0, self.t_end, rec = t0, t_end, self.rec
        while time.monotonic() < t0:
            time.sleep(0.0005)
        self.go.set()
        self.thread.join()
        if self.error is not None:
            raise self.error
        self._sync()
        if rec is not None and rec.on:
            raise RuntimeError("the window closed before the traced span: "
                               "lengthen the window or shorten the span")
        if self.dev.type == "cuda":
            limit = (t_end - t0) * 1e3
            done = sum(self.ev0.elapsed_time(e) <= limit for e in self.events)
        else:
            done = len(self.events) or self.count - max(
                self.traffic["warm_steps"], self.traffic["compare_steps"])
        return dict(units=int(done), attempted=int(done),
                    trace_units=self.trace_units, jobs=self.jobs)

    def finish(self, path: str) -> None:
        r = self.record
        out = dict(losses=[float(x) for x in r["losses"]], frames=r["frames"],
                   grads={k: float(v) for k, v in r["grads"].items()},
                   changes={k: float(v) for k, v in r["changes"].items()})
        np.savez(path, record=np.array(json.dumps(out)))


def _reference(cfg, traffic, seed, index, dev, tf32: bool) -> dict:
    d = inputs(cfg, traffic, seed, index, dev)
    f = d["frames"]
    size, k = cfg["image_size"], cfg["max_per_tile"]
    js = job_seed(seed, index)
    n_patch = len([s for s in (64, 72, 80, 88, 96) if s <= size]) or 1
    idx = reference_train.first_frames(js, traffic["frames"], n_patch,
                                       traffic["compare_steps"])
    frames = [dict(cam=dict(view=f["view"][i], full=f["full"][i],
                            center=f["center"][i], tan=f["tan"]),
                   aud=f["aud"][i], exp=f["au_exp"][i], image=f["image"][i],
                   face=f["face_mask"][i], hair=f["hair_mask"][i],
                   mouth=f["mouth_mask"][i]) for i in idx]
    extent = reference_train.scene_extent(d["centers"])
    cloud = reference_train.init_cloud(cfg["init_num"], js, 1, dev)
    _, oc = configs(cfg, traffic)
    opt = {key: getattr(oc, key) for key in OPT_KEYS}
    opt.update(warm_step=3000, iterations=cfg["iterations"])
    out = reference_train.face_steps(cloud, d["nets"]["face_umf"],
                                     d["nets"]["face_pmf"], frames, size, k,
                                     cfg["face"]["sh_degree"], extent, opt,
                                     tf32)
    out["frames"] = idx
    return out


def check(cell: dict, seed: int, samples: list, dev, tf32: bool = False):
    """Judge each job's first steps against the reference in float32 (with
    ``tf32``, the reference in TF32 takes the program's place)."""
    cfg, traffic = cell["config"], cell["traffic"]
    worst, counts = dict(loss_gap=0.0, grad_gap=0.0, change_gap=0.0), []
    for index, smp in enumerate(samples):
        ref = _reference(cfg, traffic, seed, index, dev, False)
        got = (json.loads(str(smp["record"])) if not tf32 else
               _reference(cfg, traffic, seed, index, dev, True))
        if got["frames"] != ref["frames"]:
            # another frame than the curriculum's: no number can hold
            g = dict(loss_gap=1e30, grad_gap=1e30, change_gap=1e30)
        else:
            g = reference_train.gaps(got, ref)
        worst = {k: max(worst[k], g[k]) for k in worst}
        counts.append(ref["counts"])
    mean = {"face": {k: float(np.mean([c[k] for c in counts]))
                     for k in counts[0]}} if counts else {}
    return dict(numbers=worst, counts=mean)


def control_samples(cell: dict, seed: int) -> list:
    return [None] * cell["clients"]
