"""PEM: the full pose-estimation network.

Port of `sam6d_tpu/models/pem.py` (reference `model/pose_estimation_model.py`
+ `model/feature_extraction.py:122-181`). Submodule names follow the
reference `state_dict` (`feature_extraction.rgb_net`, `geo_embedding`,
`coarse_point_matching`, `fine_point_matching` with its `PE`), so a reference
checkpoint loads without conversion. `infer` is split into a coarse half
(`infer_coarse`, returning init_R / init_t) and a fine half (`infer_fine`);
`train_forward` is the training forward (every block's similarities, the
positional encodings' BatchNorm in train mode).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..core.config import PEMConfig
from .coarse_matching import CoarsePointMatching
from .fine_matching import FinePointMatching
from .geo_transformer import GeometricStructureEmbedding
from .vit import ViTEncoder, sample_pixel_feats
from ..ops.geometry import inverse_transform_points
from ..ops.sampling import sample_pts_feats
from ..pose.solvers import compute_coarse_Rt, compute_fine_Rt

# template-side arrays the pipeline caches at onboarding (batch 1)
TEMPLATE_CACHE_KEYS = ("pe_o", "sparse_po", "sparse_fo", "fps_idx_o", "geo_o")


class PEMNet(nn.Module):
    """Pose Estimation Model.

    `inputs` of infer (batched, fixed shapes):
      rgb         (B, S, S, 3) normalized crops
      rgb_choose  (B, N_fine) flat pixel indices of observed points
      pts         (B, N_fine, 3) observed cloud (meters, camera frame)
      model       (B, N_model, 3) CAD sample points (meters)
      dense_po    (B or 1, N_fine, 3) template cloud (model frame, meters)
      dense_fo    (B or 1, N_fine, C) template features
    plus, optionally, the batch-1 onboarding cache (TEMPLATE_CACHE_KEYS).
    """

    def __init__(self, cfg: PEMConfig):
        super().__init__()
        self.cfg = cfg
        v = cfg.vit
        self.feature_extraction = ViTEncoder(
            v.img_size, v.patch_size, v.embed_dim, v.depth, v.num_heads,
            v.mlp_ratio, v.out_dim, v.use_pyramid_feat, v.remat)
        g = cfg.geo_embedding
        self.geo_embedding = GeometricStructureEmbedding(
            g.hidden_dim, g.sigma_d, g.sigma_a, g.angle_k, g.reduction_a)
        c = cfg.coarse
        self.coarse_point_matching = CoarsePointMatching(
            c.nblock, c.input_dim, c.hidden_dim, c.out_dim, c.num_heads,
            c.temp, c.normalize_feat)
        f = cfg.fine
        self.fine_point_matching = FinePointMatching(
            f.nblock, f.input_dim, f.hidden_dim, f.out_dim, f.num_heads,
            f.temp, f.normalize_feat, f.focusing_factor, f.pe_radius1,
            f.pe_radius2, f.pe_nsample1, f.pe_nsample2)

    # ----------------------------------------------------------------- utils

    def extract_img_feats(self, rgb, rgb_choose):
        """Per-pixel features at the observed pixels: the 56^2 map sampled
        bilinearly at the chosen 224^2 pixels (no full-res map)."""
        fmap_low, _ = self.feature_extraction(rgb, full_res=False)
        return sample_pixel_feats(fmap_low, rgb_choose, (rgb.shape[1], rgb.shape[2]))

    def template_pe(self, dense_po_normalized):
        """Positional encoding of the radius-normalized template cloud
        (pose-independent; cached at onboarding)."""
        return self.fine_point_matching.PE(dense_po_normalized)

    def _geo_with_bg(self, sparse_pts):
        B = sparse_pts.shape[0]
        bg_point = torch.full((B, 1, 3), 100.0, dtype=sparse_pts.dtype,
                              device=sparse_pts.device)
        return self.geo_embedding(torch.cat([bg_point, sparse_pts], dim=1))

    def template_trunk(self, dense_po_normalized, dense_fo):
        """Pose-independent template side of the coarse trunk: FPS + geometric
        structure embedding of the normalized template cloud."""
        sparse_po, sparse_fo, fps_idx_o = sample_pts_feats(
            dense_po_normalized, dense_fo, self.cfg.coarse_npoint)
        return dict(sparse_po=sparse_po, sparse_fo=sparse_fo,
                    fps_idx_o=fps_idx_o, geo_o=self._geo_with_bg(sparse_po))

    def extract_template_feats(self, tem_rgb, tem_choose, tem_pts,
                               valid_mask=None):
        """Onboard templates: per-view pixel features, views concatenated,
        FPS to fine_npoint (reference get_obj_feats :170-181). tem_rgb
        (V, S, S, 3), tem_choose (V, P), tem_pts (V, P, 3). Returns
        (dense_po (fine_npoint, 3), dense_fo (fine_npoint, C))."""
        feats = self.extract_img_feats(tem_rgb, tem_choose)        # (V, P, C)
        V, P, C = feats.shape
        vm = None if valid_mask is None else valid_mask.reshape(1, V * P)
        po, fo, _ = sample_pts_feats(tem_pts.reshape(1, V * P, 3),
                                     feats.reshape(1, V * P, C),
                                     self.cfg.fine_npoint, vm)
        return po[0], fo[0]

    # ------------------------------------------------------------- main path

    def _shared_trunk(self, inputs: Dict[str, Any]):
        """Feature extraction + radius normalization + FPS + geometric
        embeddings (reference Net.forward :23-37)."""
        c = self.cfg
        dense_fm = self.extract_img_feats(inputs["rgb"], inputs["rgb_choose"])
        B = dense_fm.shape[0]
        dense_po = inputs["dense_po"].expand(B, -1, -1)
        dense_fo = inputs["dense_fo"].expand(B, -1, -1)
        radius = torch.linalg.vector_norm(dense_po, dim=2).amax(dim=1)   # (B,)
        denom = radius[:, None, None] + 1e-6
        dense_pm = inputs["pts"] / denom
        dense_po = dense_po / denom

        sparse_pm, sparse_fm, fps_idx_m = sample_pts_feats(
            dense_pm, dense_fm, c.coarse_npoint)
        geo_m = self._geo_with_bg(sparse_pm)
        if "geo_o" in inputs:
            # onboarding cache, batch 1: shared by every item, not copied
            sparse_po = inputs["sparse_po"].expand(B, -1, -1)
            sparse_fo = inputs["sparse_fo"].expand(B, -1, -1)
            fps_idx_o = inputs["fps_idx_o"]
            geo_o = inputs["geo_o"]
        else:
            sparse_po, sparse_fo, fps_idx_o = sample_pts_feats(
                dense_po, dense_fo, c.coarse_npoint)
            geo_o = self._geo_with_bg(sparse_po)
        return dict(dense_pm=dense_pm, dense_fm=dense_fm, dense_po=dense_po,
                    dense_fo=dense_fo, radius=radius, sparse_pm=sparse_pm,
                    sparse_fm=sparse_fm, fps_idx_m=fps_idx_m, geo_m=geo_m,
                    sparse_po=sparse_po, sparse_fo=sparse_fo,
                    fps_idx_o=fps_idx_o, geo_o=geo_o)

    def infer_coarse(self, inputs: Dict[str, Any],
                     generator: torch.Generator | None = None,
                     u: torch.Tensor | None = None):
        """Trunk + coarse matching + hypothesis solve. Returns (trunk dict,
        model points normalized, init_R, init_t in normalized units). The
        hypothesis sampler's (B, 3 * coarse.nproposal1) uniforms are `u`
        when given, else drawn from `generator`."""
        c = self.cfg
        tr = self._shared_trunk(inputs)
        model_n = inputs["model"] / (tr["radius"][:, None, None] + 1e-6)
        coarse_atten = self.coarse_point_matching(
            tr["sparse_fm"], tr["geo_m"], tr["sparse_fo"], tr["geo_o"])[-1]
        init_R, init_t = compute_coarse_Rt(
            coarse_atten, tr["sparse_pm"], tr["sparse_po"], model_n,
            c.coarse.nproposal1, c.coarse.nproposal2, generator=generator, u=u)
        return tr, model_n, init_R, init_t

    def infer_fine(self, tr, model_n, init_R, init_t, pe_o=None):
        """Fine matching + weighted SVD from a coarse pose (normalized
        units). Returns (pred_R, pred_t normalized, pred_pose_score)."""
        p1_init = inverse_transform_points(tr["dense_pm"], init_R, init_t)
        pe1 = self.template_pe(p1_init)
        if pe_o is None:
            pe_o = self.template_pe(tr["dense_po"])
        fine_atten = self.fine_point_matching(
            pe1, tr["dense_fm"], tr["geo_m"], tr["fps_idx_m"],
            pe_o, tr["dense_fo"], tr["geo_o"], tr["fps_idx_o"])[-1]
        return compute_fine_Rt(fine_atten, tr["dense_pm"], tr["dense_po"],
                               model_n, dis_thres=self.cfg.dis_thres)

    def infer(self, inputs: Dict[str, Any],
              generator: torch.Generator | None = None,
              u: torch.Tensor | None = None):
        """Full inference: dict with init_R, init_t, pred_R, pred_t (meters)
        and pred_pose_score. `u`: the sampler's uniforms, as infer_coarse
        takes them (the exported program's input in place of a generator)."""
        tr, model_n, init_R, init_t = self.infer_coarse(inputs, generator, u)
        pred_R, pred_t, score = self.infer_fine(tr, model_n, init_R, init_t,
                                                inputs.get("pe_o"))
        scale = tr["radius"][:, None] + 1e-6
        return dict(init_R=init_R, init_t=init_t * scale, pred_R=pred_R,
                    pred_t=pred_t * scale, pred_pose_score=score)

    def train_forward(self, inputs: Dict[str, Any], init_R, init_t):
        """Training forward (reference feature_extraction.py:144-163 +
        pose_estimation_model.py): templates are onboarded per sample from
        the two views tem1/tem2 (2 x P points -> FPS to fine_npoint), the
        coarse and fine matchers return every block's similarities, and the
        positional encodings run their BatchNorm in train mode (the running
        statistics move twice: the posed observed cloud, then the template
        cloud). `init_R` / `init_t` is the noisy GT pose (aug_pose_noise) in
        normalized translation units. Returns (coarse_attens, fine_attens,
        aux) with aux the normalized clouds and radius the loss needs."""
        c = self.cfg
        tem_pts = torch.cat([inputs["tem1_pts"], inputs["tem2_pts"]], dim=1)
        radius = torch.linalg.vector_norm(tem_pts, dim=2).amax(dim=1)
        denom = radius[:, None, None] + 1e-6

        f1 = self.extract_img_feats(inputs["tem1_rgb"], inputs["tem1_choose"])
        f2 = self.extract_img_feats(inputs["tem2_rgb"], inputs["tem2_choose"])
        dense_po, dense_fo, _ = sample_pts_feats(
            tem_pts / denom, torch.cat([f1, f2], dim=1), c.fine_npoint)

        dense_fm = self.extract_img_feats(inputs["rgb"], inputs["rgb_choose"])
        dense_pm = inputs["pts"] / denom
        sparse_pm, sparse_fm, fps_idx_m = sample_pts_feats(
            dense_pm, dense_fm, c.coarse_npoint)
        geo_m = self._geo_with_bg(sparse_pm)
        sparse_po, sparse_fo, fps_idx_o = sample_pts_feats(
            dense_po, dense_fo, c.coarse_npoint)
        geo_o = self._geo_with_bg(sparse_po)

        coarse_attens = self.coarse_point_matching(
            sparse_fm, geo_m, sparse_fo, geo_o, all_blocks=True)

        pe = self.fine_point_matching.PE
        pe1 = pe(inverse_transform_points(dense_pm, init_R, init_t), train=True)
        pe2 = pe(dense_po, train=True)
        fine_attens = self.fine_point_matching(
            pe1, dense_fm, geo_m, fps_idx_m, pe2, dense_fo, geo_o, fps_idx_o,
            all_blocks=True, train=True)
        aux = dict(sparse_pm=sparse_pm, sparse_po=sparse_po,
                   dense_pm=dense_pm, dense_po=dense_po, radius=radius)
        return coarse_attens, fine_attens, aux

    def forward(self, inputs, generator=None):
        return self.infer(inputs, generator)
