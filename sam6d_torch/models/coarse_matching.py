"""Coarse point matching head (port of `sam6d_tpu/models/coarse_matching.py`,
reference `model/coarse_point_matching.py`). Returns similarity matrices; the
pose solve lives in `sam6d_torch.pose.solvers`."""
from __future__ import annotations

import torch
from torch import nn

from .geo_transformer import GeometricTransformer


def cosine_similarity_matrix(f1, f2, temp: float, normalize: bool = True):
    """(B, N, C) x (B, M, C) -> (B, N, M) cosine similarity / temp
    (reference model_utils.compute_feature_similarity)."""
    if normalize:
        f1 = f1 / torch.clamp(torch.linalg.vector_norm(f1, dim=-1, keepdim=True), min=1e-12)
        f2 = f2 / torch.clamp(torch.linalg.vector_norm(f2, dim=-1, keepdim=True), min=1e-12)
    return (f1 @ f2.transpose(-1, -2)) / temp


class CoarsePointMatching(nn.Module):
    def __init__(self, nblock: int = 3, input_dim: int = 256,
                 hidden_dim: int = 256, out_dim: int = 256, num_heads: int = 4,
                 temp: float = 0.1, normalize_feat: bool = True):
        super().__init__()
        self.temp = temp
        self.normalize_feat = normalize_feat
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        self.out_proj = nn.Linear(hidden_dim, out_dim)
        self.bg_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.transformers = nn.ModuleList(
            [GeometricTransformer(hidden_dim, num_heads) for _ in range(nblock)])

    def forward(self, f1, geo1, f2, geo2, all_blocks: bool = False):
        """f1 (B, N1, input_dim) observed, f2 (B, N2, input_dim) template;
        geo* (B or 1, N+1, N+1, C) embeddings incl. bg. Returns a list of
        (B, N1+1, N2+1) similarities (every block if all_blocks, else last)."""
        B = f1.shape[0]
        dt = self.in_proj.weight.dtype
        bg = self.bg_token.expand(B, -1, -1)
        f1 = torch.cat([bg, self.in_proj(f1.to(dt))], dim=1)
        f2 = torch.cat([bg, self.in_proj(f2.to(dt).expand(B, -1, -1))], dim=1)
        sims = []
        for i, block in enumerate(self.transformers):
            f1, f2 = block(f1, geo1, f2, geo2)
            if all_blocks or i == len(self.transformers) - 1:
                sims.append(cosine_similarity_matrix(
                    self.out_proj(f1), self.out_proj(f2), self.temp,
                    self.normalize_feat))
        return sims
