"""FastSAM (YOLOv8-seg) in PyTorch, NCHW.

Port of `sam6d_tpu/models/fastsam.py`. The module tree keeps the
ultralytics names, so a FastSAM-x.pt `state_dict` loads with
`load_state_dict` once its `model.model.` prefix becomes `model.`
(`weights/fastsam.py`): `model.{i}` is layer i of the yolov8-seg yaml,
`model.22` the Segment head (`cv2`/`cv3`/`cv4` branches, `proto`). Layers
10, 13 (nearest x2 upsampling) and 11, 14, 17, 20 (concatenations) hold no
parameters and run inline in `FastSAMNet.features`. The DFL's fixed
`arange` conv (`model.22.dfl`) is computed, not stored.

BatchNorm runs in eval mode with eps 1e-3 on its running statistics.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _mk(v, divisor=8):
    return int(math.ceil(v / divisor) * divisor)


class ConvBnSiLU(nn.Module):
    """ultralytics Conv: Conv2d (no bias, 'same' padding) -> BN -> SiLU."""

    def __init__(self, c_in: int, c_out: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, k, s, k // 2, bias=False)
        self.bn = nn.BatchNorm2d(c_out, eps=1e-3, momentum=0.03)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class Bottleneck(nn.Module):
    def __init__(self, c_in: int, c_out: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBnSiLU(c_in, c_out, 3)
        self.cv2 = ConvBnSiLU(c_out, c_out, 3)
        self.add = shortcut and c_in == c_out

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C2f(nn.Module):
    """cv1 to 2c channels, split in halves, n bottlenecks chained off the
    second half, every part concatenated (halves first) into cv2."""

    def __init__(self, c_in: int, c_out: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        c = c_out // 2
        self.c = c
        self.cv1 = ConvBnSiLU(c_in, 2 * c, 1)
        self.cv2 = ConvBnSiLU((2 + n) * c, c_out, 1)
        self.m = nn.ModuleList(Bottleneck(c, c, shortcut) for _ in range(n))

    def forward(self, x):
        y = self.cv1(x)
        parts = [y[:, :self.c], y[:, self.c:]]
        for m in self.m:
            parts.append(m(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """cv1 to c_in/2 channels, three chained 5x5 max pools (stride 1, -inf
    padding), the four maps concatenated into cv2."""

    def __init__(self, c_in: int, c_out: int, k: int = 5):
        super().__init__()
        c = c_in // 2
        self.cv1 = ConvBnSiLU(c_in, c, 1)
        self.cv2 = ConvBnSiLU(4 * c, c_out, 1)
        self.m = nn.MaxPool2d(k, 1, k // 2)

    def forward(self, x):
        outs = [self.cv1(x)]
        for _ in range(3):
            outs.append(self.m(outs[-1]))
        return self.cv2(torch.cat(outs, dim=1))


class Proto(nn.Module):
    """Mask prototypes: Conv 3x3, ConvTranspose 2x2 stride 2, Conv 3x3,
    Conv 1x1 -> (B, nm, H/4, W/4) off the stride-8 level."""

    def __init__(self, c_in: int, mid: int = 256, nm: int = 32):
        super().__init__()
        self.cv1 = ConvBnSiLU(c_in, mid, 3)
        self.upsample = nn.ConvTranspose2d(mid, mid, 2, 2, 0, bias=True)
        self.cv2 = ConvBnSiLU(mid, mid, 3)
        self.cv3 = ConvBnSiLU(mid, nm, 1)

    def forward(self, x):
        return self.cv3(self.cv2(self.upsample(self.cv1(x))))


class DetectBranch(nn.Sequential):
    """One head branch: two Conv-BN-SiLU 3x3 and a plain 1x1 Conv2d
    (ultralytics `nn.Sequential` indices 0, 1, 2)."""

    def __init__(self, c_in: int, mid: int, out: int):
        super().__init__(ConvBnSiLU(c_in, mid, 3), ConvBnSiLU(mid, mid, 3),
                         nn.Conv2d(mid, out, 1))


class SegmentHead(nn.Module):
    """ultralytics Segment (module 22): per level a box branch (`cv2`, 4 x
    reg_max DFL logits), a class branch (`cv3`) and a mask-coefficient
    branch (`cv4`), and the prototype head on the stride-8 level."""

    def __init__(self, ch: Sequence[int], nc: int, nm: int, reg_max: int):
        super().__init__()
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        c4 = max(ch[0] // 4, nm)
        self.cv2 = nn.ModuleList(DetectBranch(c, c2, 4 * reg_max) for c in ch)
        self.cv3 = nn.ModuleList(DetectBranch(c, c3, nc) for c in ch)
        self.cv4 = nn.ModuleList(DetectBranch(c, c4, nm) for c in ch)
        self.proto = Proto(ch[0], _mk(256 * 1.25), nm)


class FastSAMNet(nn.Module):
    """YOLOv8-seg; the defaults are FastSAM-x (= YOLOv8x-seg: width 1.25 to
    at most 512 x 1.25, depth 1.0)."""

    STRIDES = (8, 16, 32)

    def __init__(self, widths: Tuple[int, ...] = (80, 160, 320, 640, 640),
                 depths: Tuple[int, ...] = (3, 6, 6, 3), nc: int = 1, nm: int = 32,
                 reg_max: int = 16):
        super().__init__()
        w, d = widths, depths
        self.nc, self.nm, self.reg_max = nc, nm, reg_max
        layers = {
            0: ConvBnSiLU(3, w[0], 3, 2),
            1: ConvBnSiLU(w[0], w[1], 3, 2),
            2: C2f(w[1], w[1], d[0], True),
            3: ConvBnSiLU(w[1], w[2], 3, 2),
            4: C2f(w[2], w[2], d[1], True),          # P3
            5: ConvBnSiLU(w[2], w[3], 3, 2),
            6: C2f(w[3], w[3], d[2], True),          # P4
            7: ConvBnSiLU(w[3], w[4], 3, 2),
            8: C2f(w[4], w[4], d[3], True),
            9: SPPF(w[4], w[4]),                     # P5
            12: C2f(w[4] + w[3], w[3], d[3]),
            15: C2f(w[3] + w[2], w[2], d[3]),
            16: ConvBnSiLU(w[2], w[2], 3, 2),
            18: C2f(w[2] + w[3], w[3], d[3]),
            19: ConvBnSiLU(w[3], w[3], 3, 2),
            21: C2f(w[3] + w[4], w[4], d[3]),
            22: SegmentHead((w[2], w[3], w[4]), nc, nm, reg_max),
        }
        self.model = nn.ModuleDict({str(i): m for i, m in layers.items()})

    def features(self, x) -> Tuple[List[Tuple[torch.Tensor, ...]], torch.Tensor]:
        """x (B, 3, H, W) in [0, 1] -> ([(box (B, 4 reg_max, h, w), cls
        (B, nc, h, w), coef (B, nm, h, w)) at strides 8, 16, 32], protos
        (B, nm, H/4, W/4)): the network up to the raw head outputs."""
        m = self.model
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")  # noqa: E731
        x = m["1"](m["0"](x))
        x4 = m["4"](m["3"](m["2"](x)))
        x6 = m["6"](m["5"](x4))
        x9 = m["9"](m["8"](m["7"](x6)))
        p4 = m["12"](torch.cat([up(x9), x6], dim=1))
        p3 = m["15"](torch.cat([up(p4), x4], dim=1))
        p4b = m["18"](torch.cat([m["16"](p3), p4], dim=1))
        p5 = m["21"](torch.cat([m["19"](p4b), x9], dim=1))
        head = m["22"]
        levels = [(head.cv2[i](f), head.cv3[i](f), head.cv4[i](f))
                  for i, f in enumerate((p3, p4b, p5))]
        return levels, head.proto(p3)

    def decode(self, levels) -> torch.Tensor:
        """The raw head outputs -> (B, A, 4 + nc + nm) per anchor [xyxy in
        input pixels, class probability, mask coefficients], anchors in
        row-major order per level, strides 8, 16, 32 concatenated."""
        R = self.reg_max
        outs = []
        for (box, cls, coef), s in zip(levels, self.STRIDES):
            B, _, H, W = box.shape
            # channels-last before the flatten, so that anchor a = y * W + x
            b = box.permute(0, 2, 3, 1).reshape(B, H * W, 4, R)
            bins = torch.arange(R, dtype=b.dtype, device=b.device)
            dist = (torch.softmax(b, dim=-1) * bins).sum(dim=-1)
            gy, gx = torch.meshgrid(torch.arange(H, dtype=b.dtype, device=b.device),
                                    torch.arange(W, dtype=b.dtype, device=b.device),
                                    indexing="ij")
            cx, cy = gx.reshape(-1) + 0.5, gy.reshape(-1) + 0.5
            xyxy = torch.stack([(cx - dist[..., 0]) * s, (cy - dist[..., 1]) * s,
                                (cx + dist[..., 2]) * s, (cy + dist[..., 3]) * s], dim=-1)
            prob = torch.sigmoid(cls.permute(0, 2, 3, 1).reshape(B, H * W, self.nc))
            coefs = coef.permute(0, 2, 3, 1).reshape(B, H * W, self.nm)
            outs.append(torch.cat([xyxy, prob, coefs], dim=-1))
        return torch.cat(outs, dim=1)

    def forward(self, x):
        """x (B, 3, H, W) in [0, 1] -> (preds (B, A, 4 + nc + nm), protos
        (B, nm, H/4, W/4))."""
        levels, protos = self.features(x)
        return self.decode(levels), protos
