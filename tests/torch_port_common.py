"""Shared set-up of the PyTorch-port parity tests: a tiny PEM configuration,
seeded numpy inputs, and one set of seeded weights in both packages (JAX
variables from `convert_pem_state_dict`, carried back into the port by
`pem_state_dict_from_flax`)."""
import numpy as np
import pytest
import torch

from sam6d_tpu.core.config import (GeoEmbeddingConfig, PEMConfig,
                                   PointMatchingConfig, ViTConfig)

# float32 on both sides; sums are taken in another order (and flax's
# LayerNorm variance is E[x^2] - E[x]^2), so outputs agree to ~1e-6 relative
ATOL = 1e-4
RTOL = 1e-4


def tiny_cfg() -> PEMConfig:
    return PEMConfig(
        coarse_npoint=24, fine_npoint=96,
        vit=ViTConfig(patch_size=16, embed_dim=64, depth=4, num_heads=4,
                      img_size=64, out_dim=32),
        geo_embedding=GeoEmbeddingConfig(hidden_dim=32),
        coarse=PointMatchingConfig(nblock=2, input_dim=32, hidden_dim=32,
                                   out_dim=32, nproposal1=120, nproposal2=30),
        fine=PointMatchingConfig(nblock=2, input_dim=32, hidden_dim=32,
                                 out_dim=32, pe_nsample1=8, pe_nsample2=16),
        img_size=64, n_sample_model_point=64, n_sample_observed_point=96,
        n_sample_template_point=200, n_template_view=2,
    )


def separated_cloud(rng, shape, radii, scale=0.25, margin=1e-5):
    """Random points with no pair within `margin` of any r^2, so radius
    decisions cannot depend on float rounding."""
    r2 = np.float32(np.asarray(radii, np.float64) ** 2)
    while True:
        pts = (rng.randn(*shape) * scale).astype(np.float32)
        p = pts.astype(np.float64)
        d2 = ((p[..., :, None, :] - p[..., None, :, :]) ** 2).sum(-1)
        if all(np.abs(d2 - r).min() > margin for r in r2):
            return pts


def tiny_inputs(rng, cfg, B=2):
    """numpy PEMNet.infer inputs (no onboarding cache)."""
    S, NF = cfg.img_size, cfg.fine_npoint
    return dict(
        rgb=rng.rand(B, S, S, 3).astype(np.float32),
        rgb_choose=rng.randint(0, S * S, (B, NF)).astype(np.int32),
        pts=(rng.rand(B, NF, 3).astype(np.float32) - 0.5) * 0.1,
        model=(rng.rand(B, cfg.n_sample_model_point, 3).astype(np.float32) - 0.5) * 0.1,
        dense_po=(rng.rand(B, NF, 3).astype(np.float32) - 0.5) * 0.1,
        dense_fo=rng.rand(B, NF, cfg.vit.out_dim).astype(np.float32),
    )


def jax_variables(cfg, seed=1):
    """(JAX PEMNet, its variables) holding the port's seeded random weights,
    converted by the JAX package's own `convert_pem_state_dict` (no JAX
    init: that costs a whole-network compile)."""
    from sam6d_tpu.models.pem import PEMNet as JaxPEMNet
    from sam6d_tpu.weights.convert_pem import convert_pem_state_dict
    from sam6d_torch.models.pem import PEMNet
    from sam6d_torch.weights.pem import random_pem_state_dict
    sd = random_pem_state_dict(PEMNet(cfg), seed)
    variables = convert_pem_state_dict(
        {k: v.numpy() for k, v in sd.items()}, vit_depth=cfg.vit.depth,
        coarse_nblock=cfg.coarse.nblock, fine_nblock=cfg.fine.nblock)
    return JaxPEMNet(cfg), variables


def torch_net(cfg, variables):
    from sam6d_torch.models.pem import PEMNet
    from sam6d_torch.weights.pem import pem_state_dict_from_flax
    net = PEMNet(cfg)
    net.load_state_dict(pem_state_dict_from_flax(variables), strict=True)
    return net.eval()


def tt(x):
    """numpy / jax array -> torch tensor (copy)."""
    return torch.from_numpy(np.array(x))


def close(got, want, atol=ATOL, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def tiny_ism_cfgs(confidence_thresh=-1.0):
    """(JAX ISMConfig, port ISMConfig) of the tiny DINOv2 matching setup of
    tests/test_ism_pipeline.py: C=32, 2 blocks, 4 heads, 28x28 input, chunk
    8, 16 proposal slots."""
    from sam6d_tpu.core import config as jc
    from sam6d_torch.core import config as pc
    dino = dict(patch_size=14, embed_dim=32, depth=2, num_heads=4, img_size=28,
                chunk_size=8)
    match = dict(confidence_thresh=confidence_thresh)
    return (jc.ISMConfig(sam=jc.SAMConfig(max_proposals=16),
                         dinov2=jc.DINOv2Config(**dino),
                         matching=jc.ISMMatchingConfig(**match)),
            pc.ISMConfig(sam=pc.SAMConfig(max_proposals=16),
                         dinov2=pc.DINOv2Config(**dino),
                         matching=pc.ISMMatchingConfig(**match)))


def tiny_dinov2_weights(cfg, seed=1, rng=None):
    """(port `state_dict`, JAX variables) of one set of seeded DINOv2
    weights; with `rng`, the LayerNorm affines and LayerScales are perturbed
    so that folding them is not a no-op."""
    from sam6d_tpu.weights.convert_dinov2 import convert_dinov2_state_dict
    from sam6d_torch.models.dinov2 import DINOv2
    from sam6d_torch.weights.dinov2 import random_dinov2_state_dict
    d = cfg.dinov2
    sd = random_dinov2_state_dict(
        DINOv2(d.img_size, d.patch_size, d.embed_dim, d.depth, d.num_heads), seed)
    if rng is not None:
        for k, v in sd.items():
            if v.dim() == 1 and not k.startswith("patch_embed"):
                sd[k] = v + torch.from_numpy(
                    (rng.randn(*v.shape) * 0.2).astype(np.float32))
    variables = convert_dinov2_state_dict(
        {k: v.numpy() for k, v in sd.items()}, depth=d.depth,
        target_grid=d.img_size // d.patch_size)
    return sd, variables


def tiny_sam_cfgs(**overrides):
    """(JAX SAMConfig, port SAMConfig) of one tiny SAM: C=32 encoder of 3
    blocks (4 heads, window 3 on a 4x4 grid, so windowed blocks pad 4 -> 6;
    block 1 global), 64x64 canvas, an 8x8 prompt grid decoded in chunks of
    8, capacity 8 (iou prefix 8 of 64 points), NMS over the top 16 of 24
    candidates, the AMG filters pinned open as bench.py pins them."""
    from sam6d_tpu.core import config as jc
    from sam6d_torch.core import config as pc
    kw = dict(model_type="tiny", encoder_embed_dim=32, encoder_depth=3,
              encoder_num_heads=4, encoder_global_attn_indexes=(1,), img_size=64,
              patch_size=16, window_size=3, prompt_embed_dim=32, points_per_side=8,
              points_per_batch=8, pred_iou_thresh=-10.0, stability_score_thresh=0.0,
              segmentor_width_size=64, max_proposals=8, amg_nms_topk=16)
    kw.update(overrides)
    return jc.SAMConfig(**kw), pc.SAMConfig(**kw)


def tiny_sam_weights(cfg, seed=1, rng=None, blocky_masks=False):
    """(JAX variables, port `state_dict`) of one set of seeded SAM weights:
    the port's random weights (biases and LayerNorm affines perturbed by
    `rng`, if given) converted by the JAX package's convert_sam_state_dict,
    and carried back by sam_state_dict_from_flax.

    `blocky_masks` gives the four taps of both upscaling ConvTransposes the
    same weights, so each patch's 4x4 low-res block is one logit: random
    taps make every mask a speckle over the whole frame, every box the
    frame, and NMS then keeps one proposal."""
    from sam6d_tpu.weights.convert_sam import convert_sam_state_dict
    from sam6d_torch.models.sam import SAM
    from sam6d_torch.weights.sam import random_sam_state_dict, sam_state_dict_from_flax
    sd = random_sam_state_dict(SAM(cfg), seed)
    if blocky_masks:
        for k in ("mask_decoder.output_upscaling.0.weight",
                  "mask_decoder.output_upscaling.3.weight"):
            sd[k] = sd[k][..., :1, :1].expand_as(sd[k]).contiguous()
    if rng is not None:
        for k, v in sd.items():
            if v.dim() == 1:
                sd[k] = v + torch.from_numpy((rng.randn(*v.shape) * 0.2).astype(np.float32))
    variables = convert_sam_state_dict(
        {k: v.numpy() for k, v in sd.items()}, depth=cfg.encoder_depth,
        grid=cfg.img_size // cfg.patch_size)
    return variables, sam_state_dict_from_flax(variables, cfg)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for a module's torch work (imported by a test
    module, it applies to that module): the suite runs in several processes
    at once, and their thread pools would otherwise contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
