"""68-point facial landmarks (task 7; counterpart of
instag_tpu/data_utils/landmarks.py): the 2D-FAN network with the public
``2DFAN-4`` checkpoints' key layout, the face_alignment package's crop and
heatmap decode, and a video-mode tracker.

The JAX package's task 7 runs the ``face_alignment`` package when it
imports and its own FAN otherwise; that package is on neither machine, so
the port runs its FAN only (JAX's own path where the package is absent).

  * ``build_fan``/``load_fan``: the network (4 stacked depth-4 hourglasses,
    256 features, 68 heatmaps); a TorchScript release (face_alignment >=
    1.2, ``2DFAN4-*.zip``) loads as it is, else a state dict (plain, under
    ``state_dict``, or with a ``module.`` prefix) into ``build_fan``.
  * ``crop`` / ``decode_heatmaps``: bbox -> (center, scale = (w + h) /
    195, y -= 0.12 h), a 256x256 crop through the 200 * scale similarity
    (OpenCV's uint8 bilinear resize, ``cv_ops.resize_linear_window``), the
    64x64
    heatmaps' argmax with the 0.25 neighbour nudge - 0.5, mapped back.
  * ``LandmarkTracker``: frame 0 from a centred square refined once around
    its first prediction, each later frame around the previous landmarks.

Weights: ``INSTAG_FAN_WEIGHTS`` or ``weights/2DFAN4.pth`` (and the other
names of ``_WEIGHT_HINTS``); without them the entry points raise. The
network runs on ``device`` in float32 (TF32 off, ``device.resolve_device``).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.image_io import read_jpegs
from ..device import resolve_device
from .cv_ops import resize_linear_window

_WEIGHT_HINTS = ("INSTAG_FAN_WEIGHTS",
                 "weights/2DFAN4.pth", "weights/2DFAN4-cd938726ad.zip",
                 "weights/2DFAN-4.pth.tar")


def _conv3x3(cin, cout):
    return nn.Conv2d(cin, cout, 3, 1, 1, bias=False)


class ConvBlock(nn.Module):
    """Pre-activated 3-way split residual block (out/2 + out/4 + out/4
    channels concatenated)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(cin)
        self.conv1 = _conv3x3(cin, cout // 2)
        self.bn2 = nn.BatchNorm2d(cout // 2)
        self.conv2 = _conv3x3(cout // 2, cout // 4)
        self.bn3 = nn.BatchNorm2d(cout // 4)
        self.conv3 = _conv3x3(cout // 4, cout // 4)
        self.downsample = None
        if cin != cout:
            self.downsample = nn.Sequential(
                nn.BatchNorm2d(cin), nn.ReLU(True),
                nn.Conv2d(cin, cout, 1, 1, bias=False))

    def forward(self, x):
        o1 = self.conv1(F.relu(self.bn1(x), True))
        o2 = self.conv2(F.relu(self.bn2(o1), True))
        o3 = self.conv3(F.relu(self.bn3(o2), True))
        out = torch.cat([o1, o2, o3], 1)
        res = x if self.downsample is None else self.downsample(x)
        return out + res


class HourGlass(nn.Module):
    def __init__(self, depth, features):
        super().__init__()
        self.depth = depth
        for level in range(1, depth + 1):
            self.add_module(f"b1_{level}", ConvBlock(features, features))
            self.add_module(f"b2_{level}", ConvBlock(features, features))
            if level == 1:
                self.add_module(f"b2_plus_{level}",
                                ConvBlock(features, features))
            self.add_module(f"b3_{level}", ConvBlock(features, features))

    def _forward(self, level, inp):
        up1 = self._modules[f"b1_{level}"](inp)
        low1 = self._modules[f"b2_{level}"](F.avg_pool2d(inp, 2, stride=2))
        if level > 1:
            low2 = self._forward(level - 1, low1)
        else:
            low2 = self._modules[f"b2_plus_{level}"](low1)
        low3 = self._modules[f"b3_{level}"](low2)
        return up1 + F.interpolate(low3, scale_factor=2, mode="nearest")

    def forward(self, x):
        return self._forward(self.depth, x)


class FAN(nn.Module):
    def __init__(self, num_modules=4):
        super().__init__()
        self.num_modules = num_modules
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(num_modules):
            self.add_module(f"m{i}", HourGlass(4, 256))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1, 1, 0))
            self.add_module(f"bn_end{i}", nn.BatchNorm2d(256))
            self.add_module(f"l{i}", nn.Conv2d(256, 68, 1, 1, 0))
            if i < num_modules - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1, 1, 0))
                self.add_module(f"al{i}", nn.Conv2d(68, 256, 1, 1, 0))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)), True)
        x = F.avg_pool2d(self.conv2(x), 2, stride=2)
        x = self.conv4(self.conv3(x))
        previous = x
        outputs = []
        for i in range(self.num_modules):
            ll = self._modules[f"top_m_{i}"](self._modules[f"m{i}"](previous))
            ll = F.relu(self._modules[f"bn_end{i}"](
                self._modules[f"conv_last{i}"](ll)), True)
            tmp_out = self._modules[f"l{i}"](ll)
            outputs.append(tmp_out)
            if i < self.num_modules - 1:
                previous = (previous + self._modules[f"bl{i}"](ll)
                            + self._modules[f"al{i}"](tmp_out))
        return outputs


def build_fan(num_modules: int = 4) -> FAN:
    """The 2D-FAN network, module names matching the public checkpoints."""
    return FAN(num_modules)


def load_state_dict(path: str, weights_only: bool = False) -> dict:
    """A checkpoint's state dict: plain or under ``state_dict``, with any
    ``module.`` prefix removed."""
    sd = torch.load(path, map_location="cpu", weights_only=weights_only)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k.removeprefix("module."): v for k, v in sd.items()}


def find_fan_weights() -> str | None:
    path = os.environ.get("INSTAG_FAN_WEIGHTS", "")
    if path:
        return path
    for cand in _WEIGHT_HINTS[1:]:
        if os.path.exists(cand):
            return cand
    return None


def load_fan(path: str | None = None, device: str | torch.device = "cuda"):
    """FAN weights on ``device``: a TorchScript archive, else a state dict
    into ``build_fan`` (its module count read from the keys, strictly)."""
    dev = resolve_device(device)
    path = path or find_fan_weights()
    if not path or not os.path.exists(path):
        raise RuntimeError(
            "FAN landmark weights not found. Set INSTAG_FAN_WEIGHTS or place "
            "a public 2DFAN-4 checkpoint under weights/ (see "
            "scripts/fetch_weights.sh). Alternatively produce .lms files "
            "with any 68-point detector (68 rows of 'x y').")
    try:
        return torch.jit.load(path, map_location=dev).eval()
    except RuntimeError:        # not a TorchScript archive
        pass
    sd = load_state_dict(path)
    n_mod = 1 + max(int(k[1:].split(".")[0]) for k in sd
                    if k[0] == "l" and k[1].isdigit())
    net = build_fan(n_mod)
    net.load_state_dict(sd)
    return net.to(dev).eval()


# the face_alignment package's crop and decode math, so that a loaded
# public checkpoint sees the distribution it was trained on

def _transform(pt, center, scale, resolution, invert=False):
    """Map an image point into the 256/64 crop frame (or back)."""
    h = 200.0 * scale
    t = np.eye(3)
    t[0, 0] = resolution / h
    t[1, 1] = resolution / h
    t[0, 2] = resolution * (-center[0] / h + 0.5)
    t[1, 2] = resolution * (-center[1] / h + 0.5)
    if invert:
        t = np.linalg.inv(t)
    p = t @ np.array([pt[0], pt[1], 1.0])
    return p[:2]


def crop(image: np.ndarray, center, scale, resolution: int = 256):
    """Square crop around (center, scale) resized to resolution (OpenCV's
    bilinear), zero-padded where the crop leaves the image. The padded
    crop is not made, so a box far larger than the frame (a tracker that
    lost the face) costs no more memory than one inside it."""
    ul = _transform([1, 1], center, scale, resolution, True).astype(int)
    br = _transform([resolution, resolution], center, scale, resolution,
                    True).astype(int)
    h, w = image.shape[:2]
    sy0, sy1 = max(0, ul[1] - 1), min(h, br[1] - 1)
    sx0, sx1 = max(0, ul[0] - 1), min(w, br[0] - 1)
    dy0, dx0 = max(0, -(ul[1] - 1)), max(0, -(ul[0] - 1))
    window = image[sy0:max(sy0, sy1), sx0:max(sx0, sx1)]
    return resize_linear_window(window, (br[1] - ul[1], br[0] - ul[0]),
                                dy0, dx0, (resolution, resolution))


def decode_heatmaps(hm: np.ndarray, center, scale) -> np.ndarray:
    """[68, 64, 64] heatmaps -> [68, 2] image-space landmarks (argmax +
    0.25-pixel gradient nudge - 0.5, inverse similarity transform)."""
    C, H, W = hm.shape
    idx = hm.reshape(C, -1).argmax(-1)
    px = (idx % W).astype(np.float64)
    py = (idx // W).astype(np.float64)
    for j in range(C):
        x, y = int(px[j]), int(py[j])
        if 0 < x < W - 1 and 0 < y < H - 1:
            px[j] += 0.25 * np.sign(hm[j, y, x + 1] - hm[j, y, x - 1])
            py[j] += 0.25 * np.sign(hm[j, y + 1, x] - hm[j, y - 1, x])
    pts = np.stack([px, py], -1) + 0.5  # 1-indexed + nudge - 0.5
    return np.stack([_transform(p, center, scale, H, True) for p in pts])


def bbox_to_center_scale(bbox) -> tuple[np.ndarray, float]:
    """face_alignment's detector-box convention: scale = (w + h) / 195, the
    center shifted up by 12% of the box height."""
    x0, y0, x1, y1 = [float(v) for v in bbox]
    center = np.array([(x0 + x1) / 2.0, (y0 + y1) / 2.0])
    center[1] -= (y1 - y0) * 0.12
    scale = (x1 - x0 + y1 - y0) / 195.0
    return center, scale


def landmarks_to_bbox(lms: np.ndarray, margin: float = 0.25) -> np.ndarray:
    x0, y0 = lms.min(0)
    x1, y1 = lms.max(0)
    mx, my = (x1 - x0) * margin, (y1 - y0) * margin
    return np.array([x0 - mx, y0 - my * 2.0, x1 + mx, y1 + my * 0.5])


class LandmarkTracker:
    """Video-mode 68-point landmark tracking with the FAN network.

    Frame 0: a centred square covering ``init_frac`` of the short side,
    refined once by re-cropping around the first prediction. Later frames
    crop around the previous frame's landmarks.
    """

    def __init__(self, net=None, init_frac: float = 0.8,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.net = load_fan(device=self.device) if net is None else net
        self.init_frac = init_frac
        self._prev: np.ndarray | None = None

    @torch.no_grad()
    def heatmaps(self, image: np.ndarray, center, scale) -> np.ndarray:
        """The network's last heatmaps [68, 64, 64] of one crop."""
        inp = crop(image, center, scale).astype(np.float32) / 255.0
        t = torch.from_numpy(inp.transpose(2, 0, 1))[None].to(self.device)
        out = self.net(t)
        return (out[-1] if isinstance(out, (list, tuple)) else out)[0] \
            .float().cpu().numpy()

    def _run(self, image: np.ndarray, center, scale) -> np.ndarray:
        return decode_heatmaps(self.heatmaps(image, center, scale), center,
                               scale)

    def __call__(self, image: np.ndarray) -> np.ndarray:
        """image: HxWx3 uint8 RGB -> [68, 2] float landmarks (x, y)."""
        if self._prev is None:
            h, w = image.shape[:2]
            s = min(h, w) * self.init_frac
            bbox = [w / 2 - s / 2, h / 2 - s / 2, w / 2 + s / 2, h / 2 + s / 2]
            lms = self._run(image, *bbox_to_center_scale(bbox))
            lms = self._run(image, *bbox_to_center_scale(
                landmarks_to_bbox(lms)))
        else:
            lms = self._run(image, *bbox_to_center_scale(
                landmarks_to_bbox(self._prev)))
        self._prev = lms
        return lms

    def reset(self):
        self._prev = None


def extract_landmarks_fan(ori_imgs_dir: str,
                          device: str | torch.device = "cuda") -> None:
    """Write reference-layout ``.lms`` files (68 rows of "x y") for every
    jpg of the directory, tracked in the JAX package's (name) order."""
    tracker = LandmarkTracker(device=device)
    paths = sorted(glob.glob(os.path.join(ori_imgs_dir, "*.jpg")))
    for s in range(0, len(paths), 32):
        chunk = paths[s:s + 32]
        for path, img in zip(chunk, read_jpegs(chunk, tracker.device)
                             .cpu().numpy()):
            np.savetxt(path.replace(".jpg", ".lms"), tracker(img), "%f")
