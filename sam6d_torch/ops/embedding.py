"""Positional / geometric embedding helpers (port of
`sam6d_tpu/ops/embedding.py`; reference `model/transformer.py`
SinusoidalPositionalEmbedding :257-283 and the pairwise part of
GeometricStructureEmbedding.get_embedding_indices :302-332)."""
from __future__ import annotations

import numpy as np
import torch

from .geometry import pairwise_sq_distance


def sinusoidal_embedding(indices: torch.Tensor, d_model: int) -> torch.Tensor:
    """indices (...,) float -> (..., d_model), interleaved [sin, cos] pairs
    (reference SinusoidalPositionalEmbedding: omega_i = x * exp(2i * (-ln
    10000 / d)))."""
    if d_model % 2 != 0:
        raise ValueError(f"odd d_model: {d_model}")
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=indices.device)
                    * (-np.log(10000.0) / d_model))
    omegas = indices[..., None] * div
    return torch.stack([torch.sin(omegas), torch.cos(omegas)], dim=-1).reshape(
        *indices.shape, d_model)


def sinusoid_phase_tables(d_model: int, scale: float = 1.0, device=None):
    """Interleaved [sin, cos] embedding as one sin: emb = sin(x[..., None] *
    div2 + phase) with div2 = repeat(div * scale, 2), phase = tile([0, pi/2]).
    Same float32 tables as the JAX package (computed in float64, rounded)."""
    if d_model % 2 != 0:
        raise ValueError(f"odd d_model: {d_model}")
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                 * (-np.log(10000.0) / d_model))
    div2 = np.repeat(div * scale, 2).astype(np.float32)
    phase = np.tile(np.array([0.0, np.pi / 2], np.float64),
                    d_model // 2).astype(np.float32)
    return (torch.from_numpy(div2).to(device),
            torch.from_numpy(phase).to(device))


def pairwise_planar_diffs(points: torch.Tensor):
    """points (B, N, 3) -> (ax, ay, az), each (B, N, N) with
    a[b, n, m] = p[b, m] - p[b, n]."""
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    return (px[:, None, :] - px[:, :, None],
            py[:, None, :] - py[:, :, None],
            pz[:, None, :] - pz[:, :, None])


def geometric_embedding_indices(points: torch.Tensor, sigma_d: float, sigma_a: float,
                                angle_k: int):
    """Distance and wedge-angle indices of GeoTransformer (reference
    get_embedding_indices, transformer.py:302-332): points (B, N, 3) ->
    (d_indices (B, N, N) = |pi - pj| / sigma_d, a_indices (B, N, N, k): the
    angles between each point's k nearest-neighbour vectors and pj - pi, in
    units of sigma_a degrees). The neighbours come from a stable sort, ties
    to the lower index, as jax.lax.top_k breaks them."""
    B, N, _ = points.shape
    d2 = pairwise_sq_distance(points, points)
    d_indices = torch.sqrt(d2) / sigma_d
    knn_idx = torch.sort(d2, dim=-1, stable=True).indices[..., 1:angle_k + 1]
    knn_pts = torch.gather(points, 1, knn_idx.reshape(B, N * angle_k, 1).expand(-1, -1, 3))
    ref_vec = knn_pts.reshape(B, N, angle_k, 3) - points[:, :, None, :]
    anc_vec = points[:, None, :, :] - points[:, :, None, :]
    ref_e, anc_e = ref_vec[:, :, None, :, :], anc_vec[:, :, :, None, :]
    sin_v = torch.linalg.vector_norm(torch.cross(ref_e.expand(-1, -1, N, -1, -1),
                                                 anc_e.expand(-1, -1, -1, angle_k, -1),
                                                 dim=-1), dim=-1)
    cos_v = (ref_e * anc_e).sum(dim=-1)
    return d_indices, torch.atan2(sin_v, cos_v) * (180.0 / (sigma_a * np.pi))
