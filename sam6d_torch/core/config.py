"""Configuration of the port's stages: frozen dataclasses with the reference
operating points as defaults.

The port's own copy of the part of `sam6d_tpu/core/config.py` it runs: the
PEM tree (reference `Pose_Estimation_Model/config/base.yaml`), the SAM
segmentor and the ISM matching tree (reference
`Instance_Segmentation_Model/configs/model/ISM_sam.yaml`), template
rendering, the PEM training tree (reference `config/base.yaml:3-13`), and
the root `Config` that `run_demo` and the CLI take. Names and defaults are
the JAX package's; fields no ported code reads (the compute dtype, the
TPU-only lowering knobs, the training tree's weight_decay and epochs) are
left out.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

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
    remat: bool = False            # recompute each block in the backward pass
    #   (training-memory lever: torch.utils.checkpoint per block instead of
    #   storing all `depth` blocks' activations; no effect on inference)


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
    loss_dis_thres: float = 0.15   # correspondence label radius (training)
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
    # BOP test-time detection filter (reference bop_test_dataset.py:24-60)
    seg_filter_score: float = 0.25
    minimum_n_point: int = 8


# --------------------------------------------------------------------- ISM


@dataclass(frozen=True)
class SAMConfig:
    """SAM ViT image encoder + automatic mask generation (reference
    build_sam.py:55-107, configs/model/segmentor_model/sam.yaml).

    Left out of the JAX package's tree: the crop cascade and the
    small-region cleanup (both off at the reference operating point) and
    the TPU-only `encoder_carry_windows`, `amg_prerank`, `amg_rank_chunk`."""
    model_type: str = "vit_h"
    encoder_embed_dim: int = 1280
    encoder_depth: int = 32
    encoder_num_heads: int = 16
    encoder_global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    img_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    prompt_embed_dim: int = 256
    # automatic mask generation
    points_per_side: int = 32
    points_per_batch: int = 128     # decode chunk (reference GPU used 64)
    pred_iou_thresh: float = 0.88
    stability_score_thresh: float = 0.85
    stability_score_offset: float = 1.0
    box_nms_thresh: float = 0.7
    segmentor_width_size: int = 640  # pre-resize width (model/sam.py:107-119)
    max_proposals: int = 512         # fixed capacity of surviving proposals
    # exact iou-prefix pass: every grid prompt's predicted IoU from the
    # factored two-way transformer, then the full decode only for the top
    # ceil(max_proposals * factor / points_per_batch) chunks of points by
    # max-channel IoU (greedy NMS keep decisions depend only on higher-IoU
    # candidates); 0 = full-grid decode
    amg_iou_prefix_factor: float = 1.0
    # NMS over the top-T candidates by IoU only (same truncation argument);
    # 0 = no truncation
    amg_nms_topk: int = 3072


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
    segmentor: str = "sam"          # 'sam' | 'fastsam' (not ported)
    sam: SAMConfig = field(default_factory=SAMConfig)
    dinov2: DINOv2Config = field(default_factory=DINOv2Config)
    matching: ISMMatchingConfig = field(default_factory=ISMMatchingConfig)
    post: ISMPostProcessConfig = field(default_factory=ISMPostProcessConfig)
    template_level: int = 0         # 42 views


# ---------------------------------------------------------------- training


@dataclass(frozen=True)
class TrainConfig:
    """PEM training (reference config/base.yaml:3-13, 58-77, 102-105)."""
    lr: float = 1e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    eps: float = 1e-6
    max_iters: int = 600_000
    warmup_iters: int = 1000
    warmup_factor: float = 1e-3
    batch_size: int = 28
    loss_clamp: float = 100.0
    seed: int = 1
    log_every: int = 50
    checkpoint_every: int = 10_000


# ------------------------------------------------------------------ render


@dataclass(frozen=True)
class RenderConfig:
    """Offline template rendering (reference Render/render_custom_templates.py)."""
    template_level: int = 0
    image_size: int = 512  # Blender default render resolution


@dataclass(frozen=True)
class Config:
    """Root config."""
    ism: ISMConfig = field(default_factory=ISMConfig)
    pem: PEMConfig = field(default_factory=PEMConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    render: RenderConfig = field(default_factory=RenderConfig)


def default_config() -> Config:
    return Config()
