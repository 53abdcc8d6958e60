"""Configuration of the port's stages: frozen dataclasses with the reference
operating points as defaults.

The port's own copy of the part of `sam6d_tpu/core/config.py` it runs: the
PEM tree (reference `Pose_Estimation_Model/config/base.yaml`) and the ISM
matching tree (reference `Instance_Segmentation_Model/configs/model/
ISM_sam.yaml`). Names and defaults are the JAX package's; fields no ported
code reads are left out.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# --------------------------------------------------------------------- PEM


@dataclass(frozen=True)
class ViTConfig:
    """MAE-style ViT backbone (reference feature_extraction.py:50-57)."""
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    img_size: int = 224
    out_dim: int = 256            # per-pixel feature dim after upscaling
    use_pyramid_feat: bool = True  # concat features of 4 blocks


@dataclass(frozen=True)
class GeoEmbeddingConfig:
    """GeoTransformer structure embedding (reference transformer.py:286-349)."""
    sigma_d: float = 0.2
    sigma_a: float = 15.0
    angle_k: int = 3
    reduction_a: str = "max"
    hidden_dim: int = 256


@dataclass(frozen=True)
class PointMatchingConfig:
    """Shared knobs of the coarse/fine matching heads (base.yaml:32-54)."""
    nblock: int = 3
    input_dim: int = 256
    hidden_dim: int = 256
    out_dim: int = 256
    temp: float = 0.1
    normalize_feat: bool = True
    num_heads: int = 4
    # coarse only
    nproposal1: int = 6000
    nproposal2: int = 300
    # fine only
    pe_radius1: float = 0.1
    pe_radius2: float = 0.2
    pe_nsample1: int = 32
    pe_nsample2: int = 64
    focusing_factor: int = 3


@dataclass(frozen=True)
class PEMConfig:
    coarse_npoint: int = 196
    fine_npoint: int = 2048
    vit: ViTConfig = field(default_factory=ViTConfig)
    geo_embedding: GeoEmbeddingConfig = field(default_factory=GeoEmbeddingConfig)
    coarse: PointMatchingConfig = field(default_factory=PointMatchingConfig)
    fine: PointMatchingConfig = field(default_factory=PointMatchingConfig)
    # test-time data knobs (base.yaml:80-92)
    img_size: int = 224
    n_sample_observed_point: int = 2048
    n_sample_model_point: int = 1024
    n_sample_template_point: int = 5000
    n_template_view: int = 42
    rgb_mask_flag: bool = True
    dis_thres: float = 0.15       # fine pose-score inlier threshold


# --------------------------------------------------------------------- ISM


@dataclass(frozen=True)
class SAMConfig:
    """The segmentor's settings the matching stage reads: the fixed proposal
    capacity. The SAM model itself is not ported yet."""
    max_proposals: int = 512


@dataclass(frozen=True)
class DINOv2Config:
    """Frozen descriptor model (reference model/dinov2.py:14-19,44-87)."""
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    img_size: int = 224
    chunk_size: int = 16            # crops per describe forward
    validity_thresh: float = 0.5    # patch validity via avgpool(mask) > 0.5


@dataclass(frozen=True)
class ISMMatchingConfig:
    """Scoring config (reference ISM_sam.yaml matching section)."""
    aggregation_function: str = "avg_5"
    confidence_thresh: float = 0.2
    visible_thred: float = 0.5
    pointcloud_sample_num: int = 2048


@dataclass(frozen=True)
class ISMPostProcessConfig:
    """post_processing_config (ISM_sam.yaml): size filters + NMS."""
    min_box_size: float = 0.05      # relative to image width
    min_mask_size: float = 3e-4     # relative to image area
    nms_thresh: float = 0.25


@dataclass(frozen=True)
class ISMConfig:
    sam: SAMConfig = field(default_factory=SAMConfig)
    dinov2: DINOv2Config = field(default_factory=DINOv2Config)
    matching: ISMMatchingConfig = field(default_factory=ISMMatchingConfig)
    post: ISMPostProcessConfig = field(default_factory=ISMPostProcessConfig)
