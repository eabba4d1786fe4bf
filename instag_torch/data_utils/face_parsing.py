"""BiSeNet face parsing (task 4; counterpart of
instag_tpu/data_utils/face_parsing.py) and the reference's class -> colour
coding (data_utils/face_parsing/test.py:38-69), in OpenCV's BGR order:

  classes 1-13 head  -> (255, 0, 0)    (blue in the written PNG)
  class 11 mouth     -> (100, 100, 100)
  classes 14-15 neck -> (0, 255, 0)
  class 16 torso     -> (0, 0, 255)    (red in the written PNG)
  classes 17-18 hair -> (0, 0, 0)
  class 18+ / cloth  -> (255, 0, 0); the background stays white

The network is BiSeNet with its ResNet-18 context path and feature fusion,
with the public 19-class CelebAMask checkpoint's key layout
(``79999_iter.pth``: ``INSTAG_BISENET_WEIGHTS`` or under ``weights/``);
without weights the task raises. It runs on ``device`` in float32.
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.image_io import read_jpegs, write_png
from ..device import resolve_device
from .cv_ops import resize_linear, resize_nearest
from .landmarks import load_state_dict


class ConvBNReLU(nn.Module):
    def __init__(self, cin, cout, ks=3, stride=1, padding=1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, ks, stride, padding, bias=False)
        self.bn = nn.BatchNorm2d(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride=1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False),
                nn.BatchNorm2d(cout))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(out + sc)


class Resnet18(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)

        def layer(cin, cout, stride):
            return nn.Sequential(BasicBlock(cin, cout, stride),
                                 BasicBlock(cout, cout, 1))
        self.layer1 = layer(64, 64, 1)
        self.layer2 = layer(64, 128, 2)
        self.layer3 = layer(128, 256, 2)
        self.layer4 = layer(256, 512, 2)

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        feat8 = self.layer2(self.layer1(x))
        feat16 = self.layer3(feat8)
        return feat8, feat16, self.layer4(feat16)


class AttentionRefinementModule(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = ConvBNReLU(cin, cout)
        self.conv_atten = nn.Conv2d(cout, cout, 1, bias=False)
        self.bn_atten = nn.BatchNorm2d(cout)

    def forward(self, x):
        feat = self.conv(x)
        atten = F.adaptive_avg_pool2d(feat, 1)
        return feat * torch.sigmoid(self.bn_atten(self.conv_atten(atten)))


class ContextPath(nn.Module):
    def __init__(self):
        super().__init__()
        self.resnet = Resnet18()
        self.arm16 = AttentionRefinementModule(256, 128)
        self.arm32 = AttentionRefinementModule(512, 128)
        self.conv_head32 = ConvBNReLU(128, 128)
        self.conv_head16 = ConvBNReLU(128, 128)
        self.conv_avg = ConvBNReLU(512, 128, 1, 1, 0)

    def forward(self, x):
        feat8, feat16, feat32 = self.resnet(x)
        avg = self.conv_avg(F.adaptive_avg_pool2d(feat32, 1))
        avg_up = F.interpolate(avg, size=feat32.shape[2:], mode="nearest")
        feat32 = self.arm32(feat32) + avg_up
        feat32_up = self.conv_head32(
            F.interpolate(feat32, size=feat16.shape[2:], mode="nearest"))
        feat16 = self.arm16(feat16) + feat32_up
        feat16_up = self.conv_head16(
            F.interpolate(feat16, size=feat8.shape[2:], mode="nearest"))
        return feat8, feat16_up, feat32_up


class FeatureFusionModule(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.convblk = ConvBNReLU(cin, cout, 1, 1, 0)
        self.conv1 = nn.Conv2d(cout, cout // 4, 1, bias=False)
        self.conv2 = nn.Conv2d(cout // 4, cout, 1, bias=False)

    def forward(self, fsp, fcp):
        feat = self.convblk(torch.cat([fsp, fcp], 1))
        atten = F.relu(self.conv1(F.adaptive_avg_pool2d(feat, 1)))
        return feat + feat * torch.sigmoid(self.conv2(atten))


class BiSeNetOutput(nn.Module):
    def __init__(self, cin, mid, n_classes):
        super().__init__()
        self.conv = ConvBNReLU(cin, mid)
        self.conv_out = nn.Conv2d(mid, n_classes, 1, bias=False)

    def forward(self, x):
        return self.conv_out(self.conv(x))


class BiSeNet(nn.Module):
    def __init__(self, n_classes=19):
        super().__init__()
        self.cp = ContextPath()
        self.ffm = FeatureFusionModule(256, 256)
        self.conv_out = BiSeNetOutput(256, 256, n_classes)
        self.conv_out16 = BiSeNetOutput(128, 64, n_classes)
        self.conv_out32 = BiSeNetOutput(128, 64, n_classes)

    def forward(self, x):
        feat8, feat16_up, _ = self.cp(x)
        out = self.conv_out(self.ffm(feat8, feat16_up))
        return F.interpolate(out, size=x.shape[2:], mode="bilinear",
                             align_corners=True)


def colorize_parsing(parsing: np.ndarray) -> np.ndarray:
    """19-class map -> the colour-coded array in BGR order."""
    h, w = parsing.shape
    color = np.full((h, w, 3), 255, np.uint8)
    color[(parsing >= 1) & (parsing <= 13)] = (255, 0, 0)
    color[parsing == 11] = (100, 100, 100)
    color[(parsing == 14) | (parsing == 15)] = (0, 255, 0)
    color[parsing == 16] = (0, 0, 255)
    color[(parsing == 17) | (parsing == 18)] = (0, 0, 0)
    if parsing.max() > 18:
        color[parsing > 18] = (255, 0, 0)
    return color


def find_weights() -> str | None:
    for cand in (os.environ.get("INSTAG_BISENET_WEIGHTS", ""),
                 "weights/79999_iter.pth", "weights/bisenet.pth"):
        if cand and os.path.exists(cand):
            return cand
    return None


def load_bisenet(path: str, device: str | torch.device = "cuda") -> BiSeNet:
    """The network with a checkpoint's weights on ``device``. Keys the
    network lacks are ignored, as the JAX package's loader ignores them;
    a weight the checkpoint lacks raises."""
    net = BiSeNet()
    missing, _ = net.load_state_dict(load_state_dict(path), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"BiSeNet checkpoint {path} lacks {missing[:5]}")
    return net.to(resolve_device(device)).eval()


_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_STD = np.array([0.229, 0.224, 0.225], np.float32)


def parsing_logits(net: BiSeNet, img: np.ndarray) -> torch.Tensor:
    """The network's logits [19, 512, 512] of an RGB uint8 frame, resized
    to 512x512 (OpenCV's bilinear) and normalized as in training."""
    inp = resize_linear(img, (512, 512)).astype(np.float32) / 255.0
    inp = (inp - _MEAN) / _STD
    dev = next(net.parameters()).device
    with torch.no_grad():
        return net(torch.from_numpy(inp.transpose(2, 0, 1))[None].to(dev))[0]


def run_parsing(ori_imgs_dir: str, parsing_dir: str,
                device: str | torch.device = "cuda") -> None:
    """Write ``parsing/{i}.png`` of every frame: the classes' colours at
    512x512, resized back to the frame's size (nearest) and written as
    OpenCV writes the BGR array."""
    dev = resolve_device(device)
    path = find_weights()
    if path is None:
        raise RuntimeError(
            "BiSeNet weights not found. Set INSTAG_BISENET_WEIGHTS or place "
            "the public 19-class CelebAMask checkpoint (79999_iter.pth) "
            "under weights/.")
    net = load_bisenet(path, dev)
    os.makedirs(parsing_dir, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(ori_imgs_dir, "*.jpg")))
    for s in range(0, len(paths), 32):
        chunk = paths[s:s + 32]
        for p, img in zip(chunk, read_jpegs(chunk, dev).cpu().numpy()):
            out = parsing_logits(net, img).argmax(0).cpu().numpy()
            color = colorize_parsing(out.astype(np.uint8))
            color = resize_nearest(color, img.shape[1::-1])
            write_png(os.path.join(parsing_dir, os.path.basename(p)
                                   .replace(".jpg", ".png")), color[..., ::-1])
