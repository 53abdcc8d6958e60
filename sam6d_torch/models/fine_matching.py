"""Fine point matching head (port of `sam6d_tpu/models/fine_matching.py`,
reference `model/fine_point_matching.py`): dense 2048(+bg)-token matching
with sparse-to-dense transformers and the two-scale ball-query positional
encoding. Returns similarity matrices; solvers are applied outside."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .coarse_matching import cosine_similarity_matrix
from .geo_transformer import SparseToDenseTransformer
from ..ops.ball_query import group_points, two_scale_ball_query


class _BNLayer(nn.Module):
    """Holds the reference `normlayer.bn` BatchNorm2d, applied channels-last
    in flax's order of operations.

    In train mode the statistics reduce over every axis but the channels
    (B, N and the samples, the ball query's repeated slots included), the
    variance is flax's biased E[x^2] - E[x]^2 clipped at 0, and the running
    buffers move as flax's BatchNorm(momentum=0.9) moves them: 0.9 of the
    old value plus 0.1 of the batch's, the variance biased (torch's own
    BatchNorm2d would take the unbiased one)."""

    MOMENTUM = 0.9

    def __init__(self, channels: int):
        super().__init__()
        self.bn = nn.BatchNorm2d(channels, eps=1e-5)

    def forward(self, x, train: bool = False):
        bn = self.bn
        if train:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                bn.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                bn.running_var.mul_(m).add_((1.0 - m) * var.detach())
                bn.num_batches_tracked.add_(1)
        else:
            mean, var = bn.running_mean, bn.running_var
        mul = torch.rsqrt(var + bn.eps) * bn.weight
        return (x - mean) * mul + bn.bias


class _ConvBNReLU(nn.Module):
    """Reference pytorch_utils layer: 1x1 Conv2d (no bias) + BN + ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.normlayer = _BNLayer(cout)

    def linear(self, x):
        return x @ self.conv.weight[:, :, 0, 0].t()


class SharedMLP(nn.Module):
    """1x1 Conv+BN+ReLU stack over channels-last (B, M, S, C) features.

    `first_linear` / `after_first` split the stack around the first
    (bias-free) projection so PositionalEncoding can apply it before the
    gather; calling the module is after_first(first_linear(x))."""

    def __init__(self, cin: int, channels):
        super().__init__()
        dims = [cin, *channels]
        for i in range(len(channels)):
            self.add_module(f"layer{i}", _ConvBNReLU(dims[i], dims[i + 1]))
        self.n = len(channels)

    def _layer(self, i) -> _ConvBNReLU:
        return getattr(self, f"layer{i}")

    def first_linear(self, x):
        return self._layer(0).linear(x)

    def after_first(self, h, train: bool = False):
        x = F.relu(self._layer(0).normlayer(h, train))
        for i in range(1, self.n):
            layer = self._layer(i)
            x = F.relu(layer.normlayer(layer.linear(x), train))
        return x

    def forward(self, x, train: bool = False):
        return self.after_first(self.first_linear(x), train)


class _Conv1d(nn.Module):
    """Reference `mlp3.conv` (Conv1d, kernel 1, with bias) applied
    channels-last."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv1d(cin, cout, 1)

    def forward(self, x):
        return x @ self.conv.weight[:, :, 0].t() + self.conv.bias


class PositionalEncoding(nn.Module):
    """Two-scale ball-query PE (reference fine_point_matching.py:90-125):
    QueryAndGroup (r1, s1) and (r2, s2) with [rel_xyz, abs_xyz] channels,
    SharedMLP [6, 32, 64, 128] each, max over samples, concat -> 1x1 conv.

    The ball query runs the CUDA kernel on a CUDA tensor (plain version on
    CPU). conv_0 is linear and bias-free, so the cloud is projected BEFORE
    the gather: conv0([p_j - p_i, p_j]) = conv0([p_j, p_j]) - conv0([p_i, 0]),
    and 32-wide rows are gathered instead of grouped 6-wide coordinates.
    `train` normalizes with the batch's statistics and moves the running
    ones (_BNLayer)."""

    def __init__(self, out_dim: int = 256, r1: float = 0.1, r2: float = 0.2,
                 nsample1: int = 32, nsample2: int = 64):
        super().__init__()
        self.r1, self.r2 = r1, r2
        self.nsample1, self.nsample2 = nsample1, nsample2
        self.mlp1 = SharedMLP(6, (32, 64, 128))
        self.mlp2 = SharedMLP(6, (32, 64, 128))
        self.mlp3 = _Conv1d(256, out_dim)

    def forward(self, pts, train: bool = False):
        idx1, idx2 = two_scale_ball_query(pts, pts, self.r1, self.nsample1,
                                          self.r2, self.nsample2)
        pp = torch.cat([pts, pts], dim=-1)
        p0 = torch.cat([pts, torch.zeros_like(pts)], dim=-1)

        def scale_feats(mlp, idx):
            u = mlp.first_linear(pp)                   # (B, N, 32)
            v = mlp.first_linear(p0)[:, :, None, :]    # centre part
            h = group_points(u, idx) - v               # (B, N, S, 32)
            return mlp.after_first(h, train).amax(dim=2)

        f = torch.cat([scale_feats(self.mlp1, idx1),
                       scale_feats(self.mlp2, idx2)], dim=-1)
        return self.mlp3(f)


class FinePointMatching(nn.Module):
    def __init__(self, nblock: int = 3, input_dim: int = 256,
                 hidden_dim: int = 256, out_dim: int = 256, num_heads: int = 4,
                 temp: float = 0.1, normalize_feat: bool = True,
                 focusing_factor: int = 3, pe_radius1: float = 0.1,
                 pe_radius2: float = 0.2, pe_nsample1: int = 32,
                 pe_nsample2: int = 64):
        super().__init__()
        self.temp = temp
        self.normalize_feat = normalize_feat
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, out_dim)
        self.bg_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.PE = PositionalEncoding(hidden_dim, pe_radius1, pe_radius2,
                                     pe_nsample1, pe_nsample2)
        self.transformers = nn.ModuleList(
            [SparseToDenseTransformer(hidden_dim, num_heads, focusing_factor)
             for _ in range(nblock)])

    def forward(self, pe1, f1, geo1, fps_idx1, pe2, f2, geo2, fps_idx2,
                all_blocks: bool = False, train: bool = False):
        """pe1/pe2 (B, N, hidden) positional encodings (pe2 may have batch
        1), f1/f2 (B, N, input_dim) dense features, geo* (B or 1, S+1, S+1,
        C) sparse embeddings, fps_idx* (B or 1, S). Returns a list of
        (B, N1+1, N2+1) similarity matrices: every block's with
        `all_blocks` (training), else the last one's. `train` is the JAX
        signature's; the blocks hold no batch statistics (the positional
        encodings, which do, are computed by the caller)."""
        B = f1.shape[0]
        bg = self.bg_token.expand(B, -1, -1)
        f1 = torch.cat([bg, self.in_proj(f1) + pe1], dim=1)
        f2 = torch.cat([bg, (self.in_proj(f2) + pe2).expand(B, -1, -1)], dim=1)
        sims = []
        for i, block in enumerate(self.transformers):
            f1, f2 = block(f1, geo1, fps_idx1, f2, geo2, fps_idx2)
            if all_blocks or i == len(self.transformers) - 1:
                sims.append(cosine_similarity_matrix(
                    self.out_proj(f1), self.out_proj(f2), self.temp,
                    self.normalize_feat))
        return sims
