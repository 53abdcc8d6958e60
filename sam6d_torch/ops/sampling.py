"""Point sampling ops: farthest-point sampling, gathers, weighted multinomial.

Port of `sam6d_tpu/ops/sampling.py`. FPS runs the CUDA kernel for a CUDA
tensor and its plain version for a CPU tensor (`sam6d_torch.kernels.fps`).
"""
from __future__ import annotations

import torch

from ..kernels.fps import farthest_point_sample

__all__ = ["farthest_point_sample", "gather_points", "sample_pts_feats",
           "normalized_cdf", "multinomial_from_weights", "random_choice_fixed"]


def gather_points(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, M) -> (B, M, C). A batch-1 idx broadcasts."""
    B = x.shape[0]
    idx = idx.long().expand(B, -1)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def sample_pts_feats(pts, feats, npoint: int, valid_mask=None):
    """FPS + gather of points and features (reference model_utils.py:53-66)."""
    idx = farthest_point_sample(pts, npoint, valid_mask)
    return gather_points(pts, idx), gather_points(feats, idx), idx


def normalized_cdf(weights: torch.Tensor) -> torch.Tensor:
    """(B, N) non-negative weights -> inclusive CDF scaled to end at ~1."""
    cdf = torch.cumsum(weights, dim=-1)
    return cdf / (cdf[..., -1:] + 1e-8)


def multinomial_from_weights(weights: torch.Tensor, num: int,
                             u: torch.Tensor | None = None,
                             generator: torch.Generator | None = None
                             ) -> torch.Tensor:
    """Sample `num` indices per row proportional to `weights` (B, N) by
    inverse CDF (reference model_utils.py:216-222). The uniforms `u` (B, num)
    come from the caller or from `generator`. Given `u`, the result is the
    count of CDF entries < u (searchsorted, side='left'), clipped to N-1.
    Returns (B, num) int64."""
    B, N = weights.shape
    cdf = normalized_cdf(weights)
    if u is None:
        u = torch.rand((B, num), generator=generator, dtype=weights.dtype,
                       device=weights.device)
    idx = torch.searchsorted(cdf, u.to(cdf.dtype).contiguous(), right=False)
    return torch.clamp(idx, max=N - 1)


def random_choice_fixed(n_valid, capacity: int, num: int, u: torch.Tensor | None = None,
                        generator: torch.Generator | None = None) -> torch.Tensor:
    """Choose `num` indices among the first `n_valid` entries of a
    fixed-capacity buffer: without replacement when n_valid >= num, else
    cycling through them (the reference data path's np.random.choice,
    run_inference_custom.py:223-227, on the device). The (capacity,)
    uniforms `u` give each slot its priority (from `generator` when not
    given); the valid slots in descending priority, ties to the lower slot,
    are taken in turn. Returns (num,) int32 in [0, n_valid); given JAX's
    draws, JAX's indices."""
    if u is None:
        u = torch.rand((capacity,), generator=generator,
                       device=None if generator is None else generator.device)
    n_valid = torch.as_tensor(n_valid, device=u.device)
    iota = torch.arange(capacity, device=u.device)
    pri = torch.where(iota < n_valid, u, torch.full_like(u, -torch.inf))
    order = torch.argsort(-pri, stable=True)
    take = torch.clamp(n_valid, min=1, max=capacity)
    return order[torch.arange(num, device=u.device) % take].to(torch.int32)
