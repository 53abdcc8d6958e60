"""Batched rigid-geometry primitives in PyTorch.

Port of `sam6d_tpu/ops/geometry.py`: the expanded pairwise distance, the
batched 3x3 symmetric eigensolver / SVD by cyclic Jacobi on per-component
planes, weighted Procrustes, and point transforms. The Jacobi solver is kept
as plain elementwise torch (no `torch.linalg` call, no host sync) so the fine
pose solve follows the JAX package step for step.
"""
from __future__ import annotations

import torch

_JACOBI_SWEEPS = 5  # 3x3 cyclic Jacobi reaches fp32 precision by sweep ~4


def pairwise_sq_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (..., N, C), y (..., M, C) -> (..., N, M): x2 - 2xy + y2 clamped at 0
    (reference model_utils.pairwise_distance)."""
    xy = x @ y.transpose(-1, -2)
    x2 = (x * x).sum(-1)[..., :, None]
    y2 = (y * y).sum(-1)[..., None, :]
    return torch.clamp(x2 - 2.0 * xy + y2, min=0.0)


def _jacobi_rotation(app, aqq, apq):
    tiny = apq.abs() < 1e-30
    tau = (aqq - app) / (2.0 * torch.where(tiny, torch.full_like(apq, 1e-30), apq))
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tiny, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _symeig3x3_planar(a00, a01, a02, a11, a12, a22):
    """Cyclic Jacobi on component planes. Returns (w ascending [3 planes],
    v [3][3] planes with v[i][j] = component i of eigenvector j)."""
    a = {(0, 0): a00, (0, 1): a01, (0, 2): a02,
         (1, 1): a11, (1, 2): a12, (2, 2): a22}
    one = torch.ones_like(a00)
    v = [[one * float(i == j) for j in range(3)] for i in range(3)]

    def comp(i, j):
        return a[(i, j)] if i <= j else a[(j, i)]

    for _ in range(_JACOBI_SWEEPS):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            c, s = _jacobi_rotation(comp(p, p), comp(q, q), comp(p, q))
            app, aqq, apq = comp(p, p), comp(q, q), comp(p, q)
            apr, aqr = comp(p, r), comp(q, r)
            a[(p, p)] = c * c * app - 2 * s * c * apq + s * s * aqq
            a[(q, q)] = s * s * app + 2 * s * c * apq + c * c * aqq
            a[(p, q)] = torch.zeros_like(apq)
            a[(min(p, r), max(p, r))] = c * apr - s * aqr
            a[(min(q, r), max(q, r))] = s * apr + c * aqr
            for i in range(3):
                vp, vq = v[i][p], v[i][q]
                v[i][p] = c * vp - s * vq
                v[i][q] = s * vp + c * vq

    w = [a[(0, 0)], a[(1, 1)], a[(2, 2)]]

    def cswap(i, j):
        swap = w[i] > w[j]
        w[i], w[j] = torch.where(swap, w[j], w[i]), torch.where(swap, w[i], w[j])
        for r_ in range(3):
            v[r_][i], v[r_][j] = (torch.where(swap, v[r_][j], v[r_][i]),
                                  torch.where(swap, v[r_][i], v[r_][j]))

    cswap(0, 1)
    cswap(1, 2)
    cswap(0, 1)
    return w, v


def symeig3x3(A: torch.Tensor):
    """Symmetric (..., 3, 3) -> (eigvals (..., 3) ascending, eigvecs
    (..., 3, 3) as columns)."""
    A = 0.5 * (A + A.transpose(-1, -2))
    w, v = _symeig3x3_planar(A[..., 0, 0], A[..., 0, 1], A[..., 0, 2],
                             A[..., 1, 1], A[..., 1, 2], A[..., 2, 2])
    return (torch.stack(w, -1),
            torch.stack([torch.stack(row, -1) for row in v], -2))


def _svd3x3_planar(h):
    """h[i][j]: component planes of a 3x3 batch -> (u, s, v) with u[i][j] /
    v[i][j] = component i of column j and s descending (eig of H^T H plus
    an orthonormal completion for rank-deficient H)."""
    def coldot(ci, cj):
        return h[0][ci] * h[0][cj] + h[1][ci] * h[1][cj] + h[2][ci] * h[2][cj]

    w, va = _symeig3x3_planar(coldot(0, 0), coldot(0, 1), coldot(0, 2),
                              coldot(1, 1), coldot(1, 2), coldot(2, 2))
    s = [torch.sqrt(torch.clamp(w[2], min=0.0)),
         torch.sqrt(torch.clamp(w[1], min=0.0)),
         torch.sqrt(torch.clamp(w[0], min=0.0))]
    v = [[va[i][2], va[i][1], va[i][0]] for i in range(3)]

    Wc = [[h[i][0] * v[0][j] + h[i][1] * v[1][j] + h[i][2] * v[2][j]
           for j in range(3)] for i in range(3)]
    scale = torch.clamp(s[0], min=1e-12)

    def norm3(x, y, z):
        return torch.sqrt(x * x + y * y + z * z)

    def normalize_or(x, y, z, fx, fy, fz, tol):
        n = norm3(x, y, z)
        ok = n > tol
        inv = 1.0 / torch.clamp(n, min=1e-30)
        return (torch.where(ok, x * inv, fx), torch.where(ok, y * inv, fy),
                torch.where(ok, z * inv, fz))

    one = torch.ones_like(s[0])
    zero = torch.zeros_like(s[0])
    u0 = normalize_or(Wc[0][0], Wc[1][0], Wc[2][0], one, zero, zero, 1e-12)

    def cross(ax, ay, az, bx, by, bz):
        return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)

    ax_, ay_, az_ = cross(*u0, zero, zero, one)
    altn = norm3(ax_, ay_, az_)
    bx_, by_, bz_ = cross(*u0, zero, one, zero)
    ok = altn > 1e-6
    ax_, ay_, az_ = (torch.where(ok, ax_, bx_), torch.where(ok, ay_, by_),
                     torch.where(ok, az_, bz_))
    n = torch.clamp(norm3(ax_, ay_, az_), min=1e-30)
    alt = (ax_ / n, ay_ / n, az_ / n)

    d0 = Wc[0][1] * u0[0] + Wc[1][1] * u0[1] + Wc[2][1] * u0[2]
    u1 = normalize_or(Wc[0][1] - d0 * u0[0], Wc[1][1] - d0 * u0[1],
                      Wc[2][1] - d0 * u0[2], *alt, 1e-6 * scale)

    d0 = Wc[0][2] * u0[0] + Wc[1][2] * u0[1] + Wc[2][2] * u0[2]
    d1 = Wc[0][2] * u1[0] + Wc[1][2] * u1[1] + Wc[2][2] * u1[2]
    cx, cy, cz = cross(*u0, *u1)
    u2 = normalize_or(Wc[0][2] - d0 * u0[0] - d1 * u1[0],
                      Wc[1][2] - d0 * u0[1] - d1 * u1[1],
                      Wc[2][2] - d0 * u0[2] - d1 * u1[2], cx, cy, cz, 1e-5 * scale)
    u = [[u0[i], u1[i], u2[i]] for i in range(3)]
    return u, s, v


def svd3x3(H: torch.Tensor):
    """(..., 3, 3) -> (U, S, V) with H = U diag(S) V^T, S descending."""
    u, s, v = _svd3x3_planar([[H[..., i, j] for j in range(3)] for i in range(3)])
    U = torch.stack([torch.stack(row, -1) for row in u], -2)
    V = torch.stack([torch.stack(row, -1) for row in v], -2)
    return U, torch.stack(s, -1), V


def _det3_planar(m):
    return (m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1])
            - m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0])
            + m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]))


def weighted_procrustes(src_points: torch.Tensor, ref_points: torch.Tensor,
                        weights: torch.Tensor | None = None,
                        weight_thresh: float = 0.0, eps: float = 1e-5):
    """Weighted Kabsch: (R, t) with ref ~= src @ R^T + t.

    src_points, ref_points (..., N, 3); weights (..., N) or None.
    H = src_c^T (w * ref_c); R = V diag(1, 1, det) U^T; t = ref_c0 - R src_c0.
    """
    if weights is None:
        weights = torch.ones(src_points.shape[:-1], dtype=src_points.dtype,
                             device=src_points.device)
    weights = torch.where(weights < weight_thresh, torch.zeros_like(weights),
                          weights)
    weights = weights / (weights.sum(-1, keepdim=True) + eps)

    s = [src_points[..., c] for c in range(3)]
    r = [ref_points[..., c] for c in range(3)]
    sc = [(x * weights).sum(-1) for x in s]
    rc = [(x * weights).sum(-1) for x in r]
    s = [x - c[..., None] for x, c in zip(s, sc)]
    r = [x - c[..., None] for x, c in zip(r, rc)]

    h = [[(s[c] * weights * r[d]).sum(-1) for d in range(3)] for c in range(3)]
    u, _, v = _svd3x3_planar(h)
    d = _det3_planar(v) * _det3_planar(u)
    Rp = [[v[i][0] * u[j][0] + v[i][1] * u[j][1] + d * v[i][2] * u[j][2]
           for j in range(3)] for i in range(3)]
    tp = [rc[i] - (Rp[i][0] * sc[0] + Rp[i][1] * sc[1] + Rp[i][2] * sc[2])
          for i in range(3)]
    R = torch.stack([torch.stack(row, -1) for row in Rp], -2)
    return R, torch.stack(tp, -1)


def rotation_from_euler_zyx(a1, a2, a3):
    """Rz(a1) @ Rx(a2) @ Ry(a3), the composition aug_pose_noise uses
    (reference model_utils.py:150-172). Angles in radians, batched (...,)."""
    c1, s1 = torch.cos(a1), torch.sin(a1)
    c2, s2 = torch.cos(a2), torch.sin(a2)
    c3, s3 = torch.cos(a3), torch.sin(a3)
    z, o = torch.zeros_like(a1), torch.ones_like(a1)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    Rz = mat([(c1, -s1, z), (s1, c1, z), (z, z, o)])
    Rx = mat([(o, z, z), (z, c2, -s2), (z, s2, c2)])
    Ry = mat([(c3, z, s3), (z, o, z), (-s3, z, c3)])
    return Rz @ Rx @ Ry


def transform_points(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    """Model -> camera: p @ R^T + t. points (..., N, 3), R (..., 3, 3), t (..., 3)."""
    return points @ R.transpose(-1, -2) + t[..., None, :]


def inverse_transform_points(points: torch.Tensor, R: torch.Tensor,
                             t: torch.Tensor):
    """Camera -> model: (p - t) @ R."""
    return (points - t[..., None, :]) @ R
