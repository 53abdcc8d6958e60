"""MAE/timm-style ViT backbone and the linear pixel-shuffle decoder.

Port of `sam6d_tpu/models/vit.py` (reference
`Pose_Estimation_Model/model/feature_extraction.py:17-117`). Inputs stay
channels-last (B, H, W, 3) as in the JAX package; parameter names follow the
reference `state_dict` (`vit.blocks.{i}.attn.qkv`, `vit.patch_embed.proj`,
`output_upscaling`, ...). GELU is the exact erf form and attention is an
explicit matmul + softmax, as on the JAX fp32 path, or, under `use_flash`
(DINOv2 in the ISM pipeline; PEM keeps it off, as the JAX package does), the
fused-attention dispatches of `kernels/attention_qkv.py` (N <= 1024) and
`kernels/attention.py` (longer sequences).
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import fused_attention
from ..kernels.attention_qkv import fused_attention_qkv


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Attention(nn.Module):
    """Pre-LN ViT multi-head self-attention with a fused qkv projection.

    With `use_flash` the softmax(q k^T) v chain goes to a kernel dispatch
    (the CUDA kernel for a CUDA tensor, its plain version on the CPU), as
    the JAX package routes it: N <= 1024 to `kernels/attention_qkv.py`,
    which reads the qkv projection as it is, longer sequences to the
    head-major `kernels/attention.fused_attention` on the (B, H, N, hd)
    views of the projection. Otherwise it is an explicit matmul + softmax."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 use_flash: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        H = self.num_heads
        hd = C // H
        if self.use_flash and N <= 1024:
            return self.proj(fused_attention_qkv(self.qkv(x), H, hd ** -0.5))
        q, k, v = self.qkv(x).reshape(B, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        if self.use_flash:
            out = fused_attention(q, k, v, hd ** -0.5)
        else:
            out = torch.softmax((q @ k.transpose(-1, -2)) / (hd ** 0.5), dim=-1) @ v
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding as space-to-depth + one GEMM over the
    reference Conv2d weight (`proj.weight` (O, C, p, p), `proj.bias`)."""

    def __init__(self, in_chans: int, embed_dim: int, patch: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(in_chans, embed_dim, patch, stride=patch)

    def forward(self, x):
        """x (B, H, W, C) -> (B, H/p, W/p, embed_dim)."""
        B, H, W, C = x.shape
        p = self.patch
        gh, gw = H // p, W // p
        x = x.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, gh * gw, C * p * p)          # (c, dy, dx) row-major
        w = self.proj.weight.reshape(self.proj.out_channels, -1)
        y = x @ w.t() + self.proj.bias
        return y.reshape(B, gh, gw, -1)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """timm-style ViT returning the final-normed outputs of 4 pyramid blocks
    (reference ViT.forward, feature_extraction.py:21-35). With `remat`, a
    block run under autograd is checkpointed (torch.utils.checkpoint): its
    activations are recomputed in the backward pass instead of stored, the
    JAX package's `nn.remat` over the block scan."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, remat: bool = False):
        super().__init__()
        self.depth = depth
        self.remat = remat
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + grid * grid, embed_dim))
        self.blocks = nn.ModuleList(
            [Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def pyramid_indices(self) -> Sequence[int]:
        d, n = self.depth, self.depth // 4
        return sorted([d - 1, d - n - 1, d - 2 * n - 1, d - 3 * n - 1])

    def forward(self, x) -> List[torch.Tensor]:
        """x (B, H, W, 3) -> list of 4 (B, 1+N, C) normed features."""
        B = x.shape[0]
        x = self.patch_embed(x).reshape(B, -1, self.cls_token.shape[-1])
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1)
        x = x + self.pos_embed
        keep = set(self.pyramid_indices())
        outs = []
        remat = self.remat and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            x = checkpoint(blk, x, use_reentrant=False) if remat else blk(x)
            if i in keep:
                outs.append(self.norm(x))
        return outs


class ViTPixelDecoder(nn.Linear):
    """Linear pixel-shuffle upscaling head (reference ViT_AE 'linear' branch,
    feature_extraction.py:66-67,109-112): concat the 4 pyramid levels ->
    Linear(4C -> 16 * out_dim) -> 4x4 shuffle to (4g, 4g) [-> bilinear].
    It IS the reference's `output_upscaling` Linear, plus the shuffle."""

    def __init__(self, embed_dim: int = 768, out_dim: int = 256,
                 use_pyramid_feat: bool = True):
        super().__init__(embed_dim * (4 if use_pyramid_feat else 1), 16 * out_dim)
        self.out_dim = out_dim
        self.use_pyramid_feat = use_pyramid_feat

    def forward(self, pyramid, out_hw=None):
        """pyramid: list of (B, N, C) patch tokens (no cls) -> (B, 4g, 4g,
        out_dim), bilinearly resized to `out_hw` if given."""
        x = torch.cat(pyramid, dim=2) if self.use_pyramid_feat else pyramid[-1]
        B, N, _ = x.shape
        g = int(round(N ** 0.5))
        x = super().forward(x).reshape(B, g, g, 4, 4, self.out_dim)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, 4 * g, 4 * g, self.out_dim)
        if out_hw is not None:
            x = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                              mode="bilinear", align_corners=False)
            x = x.permute(0, 2, 3, 1)
        return x


def sample_pixel_feats(fmap_low: torch.Tensor, choose: torch.Tensor,
                       out_hw) -> torch.Tensor:
    """Bilinearly sample the low-res map at chosen full-res pixels, without
    materialising the (B, H, W, C) map; matches jax.image.resize 'bilinear'
    (half-pixel centres, edge clamp).

    fmap_low (B, g, g, C); choose (B, M) flat row-major indices into (H, W).
    Returns (B, M, C)."""
    B, g, _, C = fmap_low.shape
    H, W = out_hw
    choose = choose.long()
    row = (choose // W).to(torch.float32)
    col = (choose % W).to(torch.float32)
    fy = (row + 0.5) * (g / H) - 0.5
    fx = (col + 0.5) * (g / W) - 0.5
    y0 = torch.floor(fy)
    x0 = torch.floor(fx)
    wy = (fy - y0)[..., None].to(fmap_low.dtype)
    wx = (fx - x0)[..., None].to(fmap_low.dtype)
    y0i, x0i = y0.long(), x0.long()
    y0c, y1c = y0i.clamp(0, g - 1), (y0i + 1).clamp(0, g - 1)
    x0c, x1c = x0i.clamp(0, g - 1), (x0i + 1).clamp(0, g - 1)
    flat = fmap_low.reshape(B, g * g, C)

    def take(y, x):
        return torch.gather(flat, 1, (y * g + x)[..., None].expand(-1, -1, C))

    top = take(y0c, x0c) * (1 - wx) + take(y0c, x1c) * wx
    bot = take(y1c, x0c) * (1 - wx) + take(y1c, x1c) * wx
    return top * (1 - wy) + bot * wy


class ViTAE(nn.Module):
    """Reference ViT_AE: the backbone (`vit`) + the linear upscaling head
    (`output_upscaling`)."""

    def __init__(self, img_size=224, patch_size=16, embed_dim=768, depth=12,
                 num_heads=12, mlp_ratio=4.0, out_dim=256,
                 use_pyramid_feat=True, remat=False):
        super().__init__()
        self.vit = ViT(img_size, patch_size, embed_dim, depth, num_heads,
                       mlp_ratio, remat)
        self.output_upscaling = ViTPixelDecoder(embed_dim, out_dim,
                                                use_pyramid_feat)


class ViTEncoder(nn.Module):
    """Per-pixel feature extractor (reference ViTEncoder, whose `rgb_net` is
    a ViT_AE): returns ((B, H, W, out_dim) map — or the (B, 4g, 4g, out_dim)
    low-res map when full_res=False — and (B, C) cls tokens)."""

    def __init__(self, img_size=224, patch_size=16, embed_dim=768, depth=12,
                 num_heads=12, mlp_ratio=4.0, out_dim=256,
                 use_pyramid_feat=True, remat=False):
        super().__init__()
        self.rgb_net = ViTAE(img_size, patch_size, embed_dim, depth, num_heads,
                             mlp_ratio, out_dim, use_pyramid_feat, remat)

    def forward(self, x, full_res: bool = True):
        H, W = x.shape[1], x.shape[2]
        outs = self.rgb_net.vit(x)
        cls_tokens = outs[-1][:, 0, :]
        fmap = self.rgb_net.output_upscaling(
            [o[:, 1:, :] for o in outs], (H, W) if full_res else None)
        return fmap, cls_tokens
