"""Shared training pieces (counterpart of instag_tpu/train/common.py): the
frame batch on one device, built from the dataset reader's records, the
host-memory frame store of long clips, the host-side frame meta of the
curricula, the Gaussian learning rates, the lips rectangle mask and the
photometric loss."""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from ..device import resolve_device
from ..models import gaussians as G
from ..parallel.comm import all_reduce_sum, rank_slot, world
from ..parallel.mesh import shard_rows
from ..render import Camera
from ..utils.general import expon_lr
from ..utils.losses import l1_loss, ssim


@dataclasses.dataclass
class FrameBatch:
    """All frames of a split, stacked on one device (field layout as the JAX
    package's FrameBatch)."""
    view_transform: torch.Tensor       # [F,4,4]
    full_proj_transform: torch.Tensor  # [F,4,4]
    camera_center: torch.Tensor        # [F,3]
    tanfovx: torch.Tensor              # [F]
    tanfovy: torch.Tensor              # [F]
    image: torch.Tensor                # [F,H,W,3] uint8
    bg: torch.Tensor                   # [F,H,W,3] uint8
    face_mask: torch.Tensor            # [F,H,W] bool
    hair_mask: torch.Tensor
    mouth_mask: torch.Tensor
    auds: torch.Tensor                 # [F,8,D,16]
    blink: torch.Tensor                # [F]
    au_exp: torch.Tensor               # [F,6]
    lips_rect: torch.Tensor            # [F,4] int32
    lhalf_rect: torch.Tensor           # [F,4] int32
    mouth_bound: torch.Tensor          # [F,3]
    normal: torch.Tensor | None = None  # [F,H,W,3] sapiens normal prior
    depth: torch.Tensor | None = None   # [F,H,W] depth prior

    @property
    def num_frames(self) -> int:
        return self.image.shape[0]

    def camera(self, i: int) -> Camera:
        return Camera(self.view_transform[i], self.full_proj_transform[i],
                      self.camera_center[i], self.tanfovx[i], self.tanfovy[i])

    def gt_image(self, i: int) -> torch.Tensor:
        """[3,H,W] float in [0,1]."""
        return self.image[i].to(torch.float32).permute(2, 0, 1) / 255.0

    def bg_image(self, i: int) -> torch.Tensor:
        """The torso background [3,H,W], float in [0,1]."""
        return self.bg[i].to(torch.float32).permute(2, 0, 1) / 255.0


@dataclasses.dataclass
class FrameMeta:
    """The per-frame values the curricula compare with window edges, in
    float64 on the host, as the JAX package reads them from its frame
    records (``FrameBatch`` holds float32 copies, whose rounding can move a
    value across an edge)."""
    blink: np.ndarray        # [F] float64, AU45 / 2 clipped to [0, 1]
    mouth: np.ndarray        # [F] float64, the mouth opening in pixels
    mouth_lb: float          # the smallest and largest opening
    mouth_ub: float
    au25: np.ndarray         # [F] float64, AU25 clipped at its p95
    au25_pcts: tuple[float, float, float, float]   # p25, p50, p75, max
    mouth_px: np.ndarray     # [F] int64, mouth-mask pixels

    def __post_init__(self):
        for name in ("blink", "mouth", "au25"):
            setattr(self, name, np.asarray(getattr(self, name), np.float64))
        self.mouth_px = np.asarray(self.mouth_px, np.int64)
        self.mouth_lb, self.mouth_ub = float(self.mouth_lb), float(
            self.mouth_ub)
        self.au25_pcts = tuple(float(x) for x in self.au25_pcts)

    @classmethod
    def from_records(cls, records) -> "FrameMeta":
        """The meta of frame records (the port's or the JAX package's: the
        ``blink``, ``au25``, ``mouth_bound`` and ``mouth_mask`` of each), at
        the records' own precision."""
        return cls(
            blink=[r.blink for r in records],
            mouth=[r.mouth_bound[2] for r in records],
            mouth_lb=records[0].mouth_bound[0],
            mouth_ub=records[0].mouth_bound[1],
            au25=[r.au25[0] for r in records], au25_pcts=records[0].au25[1:],
            mouth_px=[int(np.asarray(r.mouth_mask).sum()) for r in records])

    @staticmethod
    def au25_stats(au25_raw) -> tuple[np.ndarray, tuple]:
        """AU25 clipped at its 95th percentile, and the clipped values' p25,
        p50, p75 and max."""
        raw = np.asarray(au25_raw, np.float64)
        au25 = np.clip(raw, 0, np.percentile(raw, 95))
        return au25, (np.percentile(au25, 25), np.percentile(au25, 50),
                      np.percentile(au25, 75), au25.max())


def streams_training_frames(model_cfg, stream_threshold: int = 1000) -> bool:
    """Whether the training frames (the train split, cut to ``N_views``,
    and the val split with ``all_for_train``) number more than
    ``stream_threshold``, counted in the transforms files before anything
    is decoded; the JAX trainers stream above 1000."""
    def count(split, n_views):
        with open(os.path.join(model_cfg.source_path,
                               f"transforms_{split}.json")) as f:
            n = len(json.load(f)["frames"])
        return min(n, n_views) if n_views > 0 else n
    n = count("train", model_cfg.N_views)
    if model_cfg.all_for_train:
        n += count("val", -1)
    return n > stream_threshold


def load_training_frames(model_cfg, device: str | torch.device = "cuda",
                         stream: bool = False):
    """The train split's records, and the val split's after them when
    ``all_for_train``. A ``stream``ed split decodes on ``device`` in chunks
    into host memory (``load_frames(host=True)``): its frames are CPU
    tensors, for a ``HostFrameStore``."""
    from ..data.dataset import load_frames
    records = load_frames(model_cfg.source_path, "train",
                          model_cfg.audio_extractor, model_cfg.N_views,
                          device=device, host=stream)
    if model_cfg.all_for_train:
        records = records + load_frames(model_cfg.source_path, "val",
                                        model_cfg.audio_extractor, -1,
                                        device=device, host=stream)
    return records


# FrameBatch field -> numpy dtype of its stack (None: the record's own); the
# images are uint8 tensors already on the reader's device
_RECORD_DTYPES = {
    "view_transform": None, "full_proj_transform": None,
    "camera_center": None, "tanfovx": np.float32, "tanfovy": np.float32,
    "face_mask": bool, "hair_mask": bool, "mouth_mask": bool,
    "auds": np.float32, "blink": np.float32, "au_exp": np.float32,
    "lips_rect": np.int32, "lhalf_rect": np.int32, "mouth_bound": np.float32,
}


def build_frame_batch(records, with_priors: bool = False,
                      device: str | torch.device = "cuda") -> FrameBatch:
    """The records stacked into a FrameBatch on ``device``, field by field
    as the JAX package stacks them; the priors only with ``with_priors``
    and when the records carry them."""
    dev = resolve_device(device)

    def stack(name, dtype=None):
        arr = np.stack([getattr(r, name) for r in records])
        return torch.from_numpy(arr if dtype is None
                                else arr.astype(dtype)).to(dev)

    fields = {name: stack(name, dtype)
              for name, dtype in _RECORD_DTYPES.items()}
    for name in ("image", "bg"):
        fields[name] = torch.stack([torch.as_tensor(getattr(r, name))
                                    for r in records]).to(dev, torch.uint8)
    if with_priors and records[0].normal is not None:
        fields["normal"] = stack("normal", np.float32)
        fields["depth"] = stack("depth", np.float32)
    return FrameBatch(**fields)


class HostFrameStore:
    """The frames of a long clip in host memory (counterpart of the JAX
    package's ``HostFrameStore``): the records stacked as a FrameBatch on
    the host (``host``), pinned when the frames go to a card, and
    ``gather(idxs)``, a block's frames as a FrameBatch on ``device``,
    gathered into pinned buffers and copied with ``non_blocking=True``, so
    that the copy of one block overlaps the card's work on the last."""

    def __init__(self, records, with_priors: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        host = build_frame_batch(records, with_priors, device="cpu")
        self.host = FrameBatch(**{
            k: v.pin_memory() if self._pin and v is not None else v
            for k, v in vars(host).items()})

    @property
    def num_frames(self) -> int:
        return self.host.num_frames

    def gather(self, idxs) -> FrameBatch:
        idx = torch.as_tensor(np.asarray(idxs, np.int64))

        def upload(x):
            if x is None:
                return None
            out = torch.empty((len(idx),) + tuple(x.shape[1:]),
                              dtype=x.dtype, pin_memory=self._pin)
            torch.index_select(x, 0, idx, out=out)
            return out.to(self.device, non_blocking=True)
        return FrameBatch(**{k: upload(v) for k, v in vars(self.host).items()})


def frame_source(records, with_priors: bool = False,
                 stream: bool | None = None, stream_threshold: int = 1000,
                 device: str | torch.device = "cuda"
                 ) -> FrameBatch | HostFrameStore:
    """The trainers' frames: a FrameBatch on ``device``, or with ``stream``
    (by default above ``stream_threshold`` frames, as the JAX trainers
    switch) a HostFrameStore that uploads each block's frames."""
    if stream is None:
        stream = len(records) > stream_threshold
    if stream:
        print(f"[train] streaming mode: {len(records)} frames stay in host "
              "memory", flush=True)
        return HostFrameStore(records, with_priors, device)
    return build_frame_batch(records, with_priors, device)


def gaussian_backward(loss_fn, state: G.GaussianState, nets):
    """Differentiate ``loss_fn(state, off) -> (loss, out)`` with respect to
    the state's parameters, the offset ``off`` [C, 2] added to the
    projected means (the densification statistics read its gradient) and
    the parameters of ``nets``: ``frames_backward`` of one frame. Returns
    ``(loss, out, grads, off_grad)``, with each net parameter's gradient
    in its ``.grad``."""
    loss, outs, grads, offs = frames_backward(
        lambda st, off, _: loss_fn(st, off), state, nets, [None], 1)
    return loss, outs[0], grads, offs[0]


def frames_backward(loss_fn, state: G.GaussianState, nets, rows, dp: int):
    """Differentiate the mean loss over a batch of ``dp`` frames, of which
    this process renders ``rows`` (all of them in one process):
    ``loss_fn(state, off, row) -> (loss, out)`` renders one frame, and each
    frame's backward runs before the next frame renders, so that one
    frame's graph is alive at a time. Returns ``(loss, outs, grads,
    off_grads)``: this process's share of the mean loss, each frame's
    ``out``, the Gaussian gradients as a GaussianParams and the offsets'
    [b, C, 2] gradients, scaled back by ``dp`` to each frame's own, as a
    serial step's (the JAX package's ``g_off * dp``). Each net parameter's
    gradient is left in its ``.grad``, zeros where a parameter does not
    reach the loss, as the JAX package's gradients are (an optimizer then
    steps every parameter, as optax does, and its bias correction keeps
    count). Nothing is summed over processes here."""
    leaves = G.GaussianParams(**{
        n: getattr(state.params, n).detach().requires_grad_(True)
        for n in G.PARAM_FIELDS})
    st = state.replace(params=leaves)
    for net in nets:
        net.zero_grad(set_to_none=True)
    loss_sum = leaves.xyz.new_zeros(())
    outs, offs = [], []
    for row in rows:
        off = torch.zeros((state.capacity, 2), device=state.params.xyz.device,
                          requires_grad=True)
        loss, out = loss_fn(st, off, row)
        (loss / dp).backward()
        loss_sum = loss_sum + loss.detach()
        outs.append(out)
        offs.append(off.grad * dp)
    for net in nets:
        for p in net.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    grads = G.GaussianParams(**{
        n: (getattr(leaves, n).grad if getattr(leaves, n).grad is not None
            else torch.zeros_like(getattr(leaves, n)))
        for n in G.PARAM_FIELDS})
    return loss_sum / dp, outs, grads, torch.stack(offs)


def adaptation_grads(step, state: G.GaussianState, rows, frame_loss):
    """The gradients of the step the face and mouth adaptation share, over
    ``step.dp`` frames of which this rank renders ``rows`` (``[i]`` for a
    serial step): ``frame_loss(state, off, i) -> (loss, out)`` renders
    frame ``i``. The Gaussian, UMF and PMF gradients of the mean loss, the
    loss and the frames' densification statistics (``G.frame_stats``) are
    summed over the ranks of ``step.group`` in one bucket, the statistics'
    maximum radius as every rank's slot, maxed here. Returns ``(mean loss,
    Gaussian grads, (accum, denom, max_radii))``, with the UMF and PMF
    gradients in their ``.grad``."""
    if state.params.xyz.device.type != step.device.type:
        raise ValueError(f"state lives on {state.params.xyz.device}, "
                         f"not {step.device}")
    nets = (step.umf_net, step.pmf_net)
    loss, outs, grads, g_offs = frames_backward(frame_loss, state, nets,
                                                rows, step.dp)
    radii = torch.stack([o.radii for o in outs])
    accum, denom, max_radii = G.frame_stats(state, g_offs, radii, radii > 0)
    net_params = [p for net in nets for p in net.parameters()]
    k, n = len(G.PARAM_FIELDS), len(net_params)
    summed = all_reduce_sum(
        [getattr(grads, f) for f in G.PARAM_FIELDS]
        + [p.grad for p in net_params]
        + [loss, accum, denom, rank_slot(max_radii, step.group)], step.group)
    for p, g in zip(net_params, summed[k:k + n]):
        p.grad = g
    loss, accum, denom, slots = summed[k + n:]
    return (loss, G.GaussianParams(**dict(zip(G.PARAM_FIELDS, summed[:k]))),
            (accum, denom, slots.amax(0)))


def adaptation_step(step, state: G.GaussianState, gopt: G.AdamState,
                    rows, it: int, frame_loss):
    """``adaptation_grads``, then one update of the Gaussians (Adam at
    ``gaussian_lrs``) and of ``step``'s UMF and PMF, which every rank
    applies alike, and the statistics added. Returns ``(state, gopt, mean
    loss)``."""
    loss, grads, stats = adaptation_grads(step, state, rows, frame_loss)
    params, gopt = G.adam_update(
        state.params, grads, gopt,
        gaussian_lrs(step.opt_cfg, it, step.spatial_lr_scale), state.alive)
    step.umf_opt.step()
    step.umf_sched.step()
    step.pmf_opt.step()
    return G.add_frame_stats(state.replace(params=params), *stats), gopt, loss


def check_data_parallel(dp: int, group) -> bool:
    """Refuse a ``dp`` that the group's world size does not divide;
    returns whether this is rank 0 (the rank that logs and writes)."""
    rank, w = world(group)
    if dp < 1 or dp % w:
        raise ValueError(f"--data_parallel {dp} does not divide over the "
                         f"{w} ranks of the process group")
    return rank == 0


def local_block(batch, draws: list, dp: int, group):
    """A block's frames for this rank: ``draws`` holds one ``(row, extra)``
    a step, ``row`` the step's ``dp`` frame indices. Returns ``(frames,
    steps)``: ``steps`` holds ``(i, extra)`` with ``i`` a frame index
    (``dp`` = 1) or this rank's ``dp / W`` indices (a list); a
    ``HostFrameStore`` uploads just those frames, which ``i`` then counts
    from 0."""
    rows = [(row[0] if dp == 1 else list(row[shard_rows(dp, group)]), x)
            for row, x in draws]
    if not isinstance(batch, HostFrameStore):
        return batch, rows
    flat = [j for i, _ in rows for j in (i if dp > 1 else [i])]
    ks = iter(range(len(flat)))
    return batch.gather(flat), [
        ([next(ks) for _ in i] if dp > 1 else next(ks), x) for i, x in rows]


def frame_camera(frames: FrameBatch, i: int, device) -> Camera:
    """Frame ``i``'s camera on ``device`` (from a batch on the device, or
    a ``HostFrameStore``'s host batch)."""
    return frames.camera(i).to(device)


def replica_tensors(state: G.GaussianState, **nets) -> dict:
    """The replicated tensors of a data-parallel run, by name: the
    Gaussian parameters and alive mask, and each net's parameters."""
    out = {f"gaussians.{n}": getattr(state.params, n)
           for n in G.PARAM_FIELDS}
    out["gaussians.alive"] = state.alive
    for tag, net in nets.items():
        out.update({f"{tag}.{n}": p for n, p in net.named_parameters()})
    return out


def rgb_loss(image: torch.Tensor, gt: torch.Tensor,
             lambda_dssim: float) -> torch.Tensor:
    """L1 + lambda (1 - SSIM), the photometric loss of every trainer."""
    return l1_loss(image, gt) + lambda_dssim * (1.0 - ssim(image, gt))


def gaussian_lrs(opt_cfg, step, spatial_lr_scale: float) -> dict:
    """Per-attribute learning rates of the Gaussian Adam; xyz follows the
    exponential schedule."""
    xyz_lr = expon_lr(step, opt_cfg.position_lr_init * spatial_lr_scale,
                      opt_cfg.position_lr_final * spatial_lr_scale,
                      lr_delay_mult=opt_cfg.position_lr_delay_mult,
                      max_steps=opt_cfg.position_lr_max_steps)
    return dict(
        xyz=xyz_lr,
        features_dc=opt_cfg.feature_lr,
        features_rest=opt_cfg.feature_lr / 20.0,
        identity=opt_cfg.identity_lr,
        opacity=opt_cfg.opacity_lr,
        scaling=opt_cfg.scaling_lr,
        rotation=opt_cfg.rotation_lr,
    )


def rect_mask(height: int, width: int, rect: torch.Tensor) -> torch.Tensor:
    """[H,W] mask, True inside rect [xmin, xmax, ymin, ymax], where x
    indexes rows (the landmark convention)."""
    rows = torch.arange(height, device=rect.device)[:, None]
    cols = torch.arange(width, device=rect.device)[None, :]
    return ((rows >= rect[0]) & (rows < rect[1]) &
            (cols >= rect[2]) & (cols < rect[3]))
