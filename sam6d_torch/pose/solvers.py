"""Pose solvers: coarse hypothesis sampling and fine weighted SVD.

Port of `sam6d_tpu/pose/solvers.py` (reference
`Pose_Estimation_Model/utils/model_utils.py` compute_coarse_Rt :187-246,
compute_fine_Rt :250-283). The 6000 three-point Kabsch solves run as one
batched Jacobi SVD; the hypothesis-to-model distance is taken in chunks of
proposals so (B, 300, 196, 1024) is never materialised. The random numbers
come from an explicit `torch.Generator` (they cannot match JAX's; parity of
the coarse solve is statistical).

Both solvers run in float32 whatever the network's dtype: the point clouds
are float32, and JAX promotes its bf16 similarities to float32 where they
meet them (the soft correspondences, the weighted Kabsch). Here the
similarity matrix is cast once on entry, so the soft assignment and the
sampling CDF over N1 x N2 weights are float32 sums too.
"""
from __future__ import annotations

import torch

from ..ops.geometry import (inverse_transform_points, pairwise_sq_distance,
                            weighted_procrustes)
from ..ops.sampling import multinomial_from_weights


def soft_assignment(atten: torch.Tensor):
    """atten (B, N1+1, N2+1) incl. bg row/col -> (score (B, N1, N2),
    w1 (B, N1), w2 (B, N2), label1 (B, N1), label2 (B, N2))."""
    pred = torch.softmax(atten, dim=2) * torch.softmax(atten, dim=1)
    label1 = pred[:, 1:, :].argmax(dim=2)
    label2 = pred[:, :, 1:].argmax(dim=1)
    w1 = (label1 > 0).to(atten.dtype)
    w2 = (label2 > 0).to(atten.dtype)
    score = pred[:, 1:, 1:] * w1[:, :, None] * w2[:, None, :]
    return score, w1, w2, label1, label2


def _chunked_min_dist_to_model(transformed, model_pts, chunk: int):
    """transformed (B, P, N1, 3), model_pts (B, M, 3) -> (B, P, N1) distance
    to the nearest model point, `chunk` proposals at a time."""
    B, P, N1, _ = transformed.shape
    out = []
    for start in range(0, P, chunk):
        sl = transformed[:, start:start + chunk]
        c = sl.shape[1]
        d2 = pairwise_sq_distance(sl.reshape(B, c * N1, 3), model_pts)
        out.append(torch.sqrt(d2.amin(dim=-1)).reshape(B, c, N1))
    return torch.cat(out, dim=1)


def compute_coarse_Rt(atten, pts1, pts2, model_pts=None,
                      n_proposal1: int = 6000, n_proposal2: int = 300,
                      dist_chunk: int = 30,
                      generator: torch.Generator | None = None,
                      u: torch.Tensor | None = None):
    """Initial pose from the coarse assignment.

    pts1 (B, N1, 3) observed (normalized), pts2 (B, N2, 3) model-frame FPS
    points, model_pts (B, M, 3) normalized CAD points for scoring. The
    (B, 3 * n_proposal1) sampling uniforms are `u` when given (JAX's
    `jax.random.uniform(key, ...)` draws them so), else they come from
    `generator`.
    Returns (R (B, 3, 3), t (B, 3)) with pts1 ~ pts2 @ R^T + t."""
    if model_pts is None:
        model_pts = pts2
    atten = atten.to(torch.float32)
    B, N1, _ = pts1.shape
    N2 = pts2.shape[1]

    score, w1, _, _, _ = soft_assignment(atten)
    flat = score.reshape(B, N1 * N2) ** 1.5
    idx = multinomial_from_weights(flat, n_proposal1 * 3, u=u, generator=generator)
    idx1 = torch.clamp(idx // N2, max=N1 - 1)
    idx2 = idx % N2
    p1 = torch.gather(pts1, 1, idx1[..., None].expand(-1, -1, 3))
    p2 = torch.gather(pts2, 1, idx2[..., None].expand(-1, -1, 3))
    p1 = p1.reshape(B, n_proposal1, 3, 3)
    p2 = p2.reshape(B, n_proposal1, 3, 3)

    Rs, ts = weighted_procrustes(p2, p1)               # (B, P1, 3, 3), (B, P1, 3)

    resid = inverse_transform_points(p1, Rs, ts) - p2
    dis = torch.linalg.vector_norm(resid, dim=-1).mean(dim=-1)   # (B, P1)
    keep = torch.topk(dis, n_proposal2, dim=1, largest=False, sorted=True).indices
    Rs = torch.gather(Rs, 1, keep[..., None, None].expand(-1, -1, 3, 3))
    ts = torch.gather(ts, 1, keep[..., None].expand(-1, -1, 3))

    transformed = inverse_transform_points(pts1[:, None], Rs, ts)  # (B, P2, N1, 3)
    dmin = _chunked_min_dist_to_model(transformed, model_pts, dist_chunk)
    scores = w1.sum(dim=1)[:, None] / ((dmin * w1[:, None, :]).sum(dim=2) + 1e-8)
    best = scores.argmax(dim=1)
    rows = torch.arange(B, device=atten.device)
    return Rs[rows, best], ts[rows, best]


def compute_fine_Rt(atten, pts1, pts2, model_pts=None, dis_thres: float = 0.15):
    """Final pose + confidence from the dense assignment: soft
    correspondences, weighted Kabsch with row-mass weights, score = inlier
    fraction x foreground fraction."""
    if model_pts is None:
        model_pts = pts2
    atten = atten.to(torch.float32)
    score, _, _, label1, _ = soft_assignment(atten)
    norm_score = score / (score.sum(dim=2, keepdim=True) + 1e-6)
    pred_pts = norm_score @ pts2
    assign_mass = score.sum(dim=2)
    R, t = weighted_procrustes(pred_pts, pts1, assign_mass, weight_thresh=0.0)

    back = inverse_transform_points(pts1, R, t)
    dmin = torch.sqrt(pairwise_sq_distance(back, model_pts).amin(dim=-1))
    fg = (label1 > 0).to(atten.dtype)
    inlier = (dmin < dis_thres).to(atten.dtype)
    pose_score = (inlier * fg).sum(dim=1) / (fg.sum(dim=1) + 1e-8)
    return R, t, pose_score * fg.mean(dim=1)
