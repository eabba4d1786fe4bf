"""EasyPortrait FPN teeth / face-part segmentor (counterpart of
instag_tpu/data_utils/easyportrait_fpn.py): the reference's mmseg
``EncoderDecoder`` (ResNetV1c-50 + FPN neck + FPNHead, 8 classes, teeth =
class 7) in plain torch, its ``state_dict`` keys those of the public
``fpn-fp-512.pth``.

  * ResNetV1c-50: the deep 3x3x3 stem (3 -> 32 -> 32 -> 64, stride 2) and
    a max pool, bottleneck layers [3, 4, 6, 3] of 256/512/1024/2048
    channels at strides 1/2/2/2 (the stride on conv2), BN everywhere;
  * FPN neck: 1x1 lateral convs (bias, no norm), top-down nearest
    upsampling and accumulation, 3x3 output convs; 256 channels, 4 levels;
  * FPNHead: per-level 3x3 conv + BN + ReLU heads with x2 bilinear
    upsamples down to stride 4, summed, then a 1x1 conv to 8 classes.

Inference is mmseg's "whole" mode: logits at stride 4, bilinear-resized to
the input, on ``device`` in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device

# test-pipeline normalization (fpn-fp.py img_norm_cfg; 0-255 domain, RGB)
_MEAN = np.array([143.55267075, 132.96705975, 126.94924335], np.float32)
_STD = np.array([60.2625333, 60.32740275, 59.30988645], np.float32)

TEETH_CLASS = 7
CLASSES = ("background", "skin", "left brow", "right brow", "left eye",
           "right eye", "lips", "teeth")


class ConvModule(nn.Module):
    """mmcv's ConvModule (conv + optional BN + ReLU) with its keys."""

    def __init__(self, cin, cout, k, stride=1, padding=0, norm=True):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, padding, bias=not norm)
        self.bn = nn.BatchNorm2d(cout) if norm else None
        self.activate = nn.ReLU(inplace=True)

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.activate(x)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = downsample

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        return self.relu(self.bn3(self.conv3(out)) + idt)


class ResNetV1c(nn.Module):
    """ResNet-50 with the deep 3-conv stem (mmseg's ResNetV1c)."""

    def __init__(self, depth=50):
        super().__init__()
        blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[depth]
        self.stem = nn.Sequential(
            nn.Conv2d(3, 32, 3, 2, 1, bias=False), nn.BatchNorm2d(32),
            nn.ReLU(inplace=True),
            nn.Conv2d(32, 32, 3, 1, 1, bias=False), nn.BatchNorm2d(32),
            nn.ReLU(inplace=True),
            nn.Conv2d(32, 64, 3, 1, 1, bias=False), nn.BatchNorm2d(64),
            nn.ReLU(inplace=True))
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, (n, planes, stride) in enumerate(zip(
                blocks, (64, 128, 256, 512), (1, 2, 2, 2))):
            layers = []
            for j in range(n):
                s = stride if j == 0 else 1
                down = None
                if j == 0 and (s != 1 or inplanes != planes * 4):
                    down = nn.Sequential(
                        nn.Conv2d(inplanes, planes * 4, 1, s, bias=False),
                        nn.BatchNorm2d(planes * 4))
                layers.append(Bottleneck(inplanes, planes, s, down))
                inplanes = planes * 4
            setattr(self, f"layer{i + 1}", nn.Sequential(*layers))

    def forward(self, x):
        x = self.maxpool(self.stem(x))
        outs = []
        for i in range(4):
            x = getattr(self, f"layer{i + 1}")(x)
            outs.append(x)
        return outs


class FPN(nn.Module):
    def __init__(self, in_channels=(256, 512, 1024, 2048), out=256):
        super().__init__()
        self.lateral_convs = nn.ModuleList(
            [ConvModule(c, out, 1, norm=False) for c in in_channels])
        self.fpn_convs = nn.ModuleList(
            [ConvModule(out, out, 3, padding=1, norm=False)
             for _ in in_channels])
        # mmseg's FPN passes act_cfg=None: no activation
        for m in list(self.lateral_convs) + list(self.fpn_convs):
            m.activate = nn.Identity()

    def forward(self, feats):
        lat = [conv(f) for conv, f in zip(self.lateral_convs, feats)]
        for i in range(len(lat) - 1, 0, -1):
            lat[i - 1] = lat[i - 1] + F.interpolate(
                lat[i], size=lat[i - 1].shape[2:], mode="nearest")
        return [conv(x) for conv, x in zip(self.fpn_convs, lat)]


class FPNHead(nn.Module):
    def __init__(self, channels=128, num_classes=8,
                 feature_strides=(4, 8, 16, 32), in_channels=256):
        super().__init__()
        self.scale_heads = nn.ModuleList()
        for s in feature_strides:
            length = max(1, int(np.log2(s) - np.log2(feature_strides[0])))
            mods = []
            for k in range(length):
                mods.append(ConvModule(in_channels if k == 0 else channels,
                                       channels, 3, padding=1, norm=True))
                if s != feature_strides[0]:
                    mods.append(nn.Upsample(scale_factor=2, mode="bilinear",
                                            align_corners=False))
            self.scale_heads.append(nn.Sequential(*mods))
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, feats):
        out = self.scale_heads[0](feats[0])
        for i in range(1, len(feats)):
            out = out + F.interpolate(
                self.scale_heads[i](feats[i]), size=out.shape[2:],
                mode="bilinear", align_corners=False)
        return self.conv_seg(out)


class EasyPortraitFPN(nn.Module):
    """mmseg EncoderDecoder(ResNetV1c-50 + FPN + FPNHead), key-compatible
    with the public EasyPortrait ``fpn-fp-512.pth`` checkpoint."""

    def __init__(self, num_classes=8):
        super().__init__()
        self.backbone = ResNetV1c(50)
        self.neck = FPN()
        self.decode_head = FPNHead(num_classes=num_classes)

    def forward(self, x):
        logits = self.decode_head(self.neck(self.backbone(x)))
        return F.interpolate(logits, size=x.shape[2:], mode="bilinear",
                             align_corners=False)


def load_fpn_fp(checkpoint_path: str,
                device: str | torch.device = "cuda") -> EasyPortraitFPN:
    """The segmentor with an mmseg checkpoint's decode path loaded (aux
    heads and EMA copies dropped), every weight present, on ``device``."""
    model = EasyPortraitFPN()
    ckpt = torch.load(checkpoint_path, map_location="cpu")
    sd = ckpt.get("state_dict", ckpt)
    sd = {k: v for k, v in sd.items()
          if k.startswith(("backbone.", "neck.", "decode_head."))
          and "num_batches_tracked" not in k}
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if "num_batches_tracked" not in k]
    if missing or unexpected:
        raise ValueError(
            f"fpn-fp checkpoint mismatch: missing={missing[:5]} "
            f"unexpected={unexpected[:5]}")
    return model.to(resolve_device(device)).eval()


def segment_logits(model: EasyPortraitFPN, img: np.ndarray) -> torch.Tensor:
    """The logits [8, H, W] of an RGB uint8 frame at its own resolution
    (normalized in 0-255, padded to a multiple of 32 and cropped back)."""
    h, w = img.shape[:2]
    inp = (img.astype(np.float32) - _MEAN) / _STD
    dev = next(model.parameters()).device
    x = torch.from_numpy(inp.transpose(2, 0, 1))[None].to(dev)
    ph, pw = -h % 32, -w % 32
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph))
    with torch.no_grad():
        return model(x)[0, :, :h, :w]


def segment(model: EasyPortraitFPN, img: np.ndarray) -> np.ndarray:
    """Whole-image inference on an RGB uint8 frame -> [H, W] uint8 class
    map (teeth = 7), as the reference's test pipeline."""
    return segment_logits(model, img).argmax(0).cpu().numpy().astype(np.uint8)
