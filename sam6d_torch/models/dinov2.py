"""DINOv2 ViT descriptor model: cls token + masked patch tokens (port of
`sam6d_tpu/models/dinov2.py`).

Parity with reference `Instance_Segmentation_Model/model/vision_transformer.py`
(DinoVisionTransformer: pre-LN blocks, LayerScale `ls1`/`ls2`, LayerNorm eps
1e-6, exact-erf GELU) and `model/dinov2.py` CustomDINOv2 (:92-258). Module
names follow the reference `state_dict` (`patch_embed.proj`, `cls_token`,
`pos_embed`, `blocks.{i}.norm1`, `blocks.{i}.attn.qkv`, `blocks.{i}.ls1.gamma`,
`norm`, ...). The 224-input position embedding is interpolated once when
weights are loaded (`weights/dinov2.py`), so the module holds a fixed
(1, 1 + g*g, C) `pos_embed`. Inputs are channels-last (B, S, S, 3).
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .vit import Attention, MlpBlock, PatchEmbed


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class DinoBlock(nn.Module):
    """`ln_folded`: norm1/norm2 keep only their statistics; their affines
    live in the qkv / fc1 weights (fold_ln_affine)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 use_flash: bool = False, ln_folded: bool = False):
        super().__init__()
        aff = not ln_folded
        self.norm1 = nn.LayerNorm(dim, eps=1e-6, elementwise_affine=aff)
        self.attn = Attention(dim, num_heads, use_flash=use_flash)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6, elementwise_affine=aff)
        self.mlp = MlpBlock(dim, int(dim * mlp_ratio), dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DINOv2(nn.Module):
    """forward returns (cls token (B, C), patch tokens (B, g*g, C)), both
    final-normed (x_norm_clstoken / x_norm_patchtokens of the reference)."""

    def __init__(self, img_size: int = 224, patch_size: int = 14,
                 embed_dim: int = 1024, depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, use_flash: bool = False,
                 ln_folded: bool = False):
        super().__init__()
        g = img_size // patch_size
        self.ln_folded = ln_folded
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + g * g, embed_dim))
        self.blocks = nn.ModuleList(
            [DinoBlock(embed_dim, num_heads, mlp_ratio, use_flash, ln_folded)
             for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x):
        B = x.shape[0]
        C = self.cls_token.shape[-1]
        x = self.patch_embed(x).reshape(B, -1, C)
        x = torch.cat([self.cls_token.expand(B, -1, -1), x], dim=1) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return x[:, 0], x[:, 1:]


def fold_ln_affine(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold every block's norm1/norm2 affine into the qkv / fc1 weights of a
    reference-layout (unfolded) DINOv2 `state_dict`:

        LN_affine(x) W^T + b == LN_stats(x) (W diag(gamma))^T + (b + W beta)

    exactly up to re-association, weight math in fp32. Use with
    DINOv2(ln_folded=True). A `state_dict` with no norm1 weights is returned
    as it is."""
    out = dict(state_dict)
    blocks = sorted({k.split(".")[1] for k in state_dict
                     if k.startswith("blocks.") and ".norm1.weight" in k}, key=int)
    for i in blocks:
        for norm, leaf in (("norm1", "attn.qkv"), ("norm2", "mlp.fc1")):
            g = out.pop(f"blocks.{i}.{norm}.weight").to(torch.float32)
            beta = out.pop(f"blocks.{i}.{norm}.bias").to(torch.float32)
            W = out[f"blocks.{i}.{leaf}.weight"]
            b = out[f"blocks.{i}.{leaf}.bias"]
            Wf = W.to(torch.float32)
            out[f"blocks.{i}.{leaf}.weight"] = (Wf * g[None, :]).to(W.dtype)
            out[f"blocks.{i}.{leaf}.bias"] = (b.to(torch.float32)
                                              + Wf @ beta).to(b.dtype)
    return out


def masked_patch_descriptors(patch_tokens: torch.Tensor,
                             proposal_masks: torch.Tensor,
                             patch_size: int = 14,
                             thresh: float = 0.5) -> torch.Tensor:
    """Zero the patches whose mask coverage is <= thresh, then L2-normalize
    (reference compute_masked_patch_feature, model/dinov2.py:214-224).

    patch_tokens (B, N, C); proposal_masks (B, S, S) in {0, 1}."""
    B, S, _ = proposal_masks.shape
    g = S // patch_size
    m = proposal_masks.reshape(B, g, patch_size, g, patch_size)
    cover = m.mean(dim=(2, 4)).reshape(B, g * g)
    feats = patch_tokens * (cover > thresh).to(patch_tokens.dtype)[..., None]
    norm = torch.linalg.vector_norm(feats, dim=-1, keepdim=True)
    return feats / torch.clamp(norm, min=1e-12)
