"""The port's bf16 inference path against the JAX package's on the CPU, at
tiny widths, with seeded numpy inputs and fan-in-scaled random weights
(`torch_port_draw.rand_like_state_dict`, the draw of
`scripts/bf16_budget.py::rand_like_tree`) carried to JAX by the JAX
package's converters:

- `cast_float_params` against the JAX function on one tree;
- the plain bf16 versions of K1, K5, K8 and K9 against the Pallas kernels in
  interpret mode on bf16 inputs, at atol 8e-3 (the JAX package's own bf16
  kernel tolerance, tests/test_pallas_kernels.py: the bf16 output's rounding);
  K1's tables, summed in its kernel's order, within one bf16 ulp of the
  einsum's;
- the nine stages of the bf16 budget, each given the inputs bf16_budget.py
  gives it (the decode and the scores take JAX's own bf16 embedding and
  descriptors; PEM's fine half a posed frame on the conditioned draw, from
  one pose near the frame's): the port's bf16
  output within the stage's budget of JAX's bf16 output (`q99_rel`), and
  within max(2 x JAX's own bf16-vs-fp32 error, 1e-3) of JAX's fp32 output,
  so that a missing fp32 island shows;
- one composed frame through the bf16 pipelines (run_demo with
  Config(dtype="bfloat16") and MultiObjectStream), every parameter bf16;
- pipelines built without `dtype` hold float32 parameters and give the
  outputs of the float32 modules bit for bit;
- the dispatches refuse float16 and mixed dtypes, and the bf16 CUDA entries
  (K1, K5, K8, K9 and K2-K4) refuse CPU tensors without counting a launch."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sam6d_tpu.core.params import cast_float_params as jax_cast_float_params
from sam6d_tpu.kernels import flash_attention as jfa
from sam6d_tpu.models import ism_scoring as jax_scoring
from sam6d_tpu.models import sam as jsam
from sam6d_tpu.models.dinov2 import DINOv2 as JaxDINOv2
from sam6d_tpu.models.pem import PEMNet as JaxPEMNet
from sam6d_tpu.pipelines.sam_amg import SAMSegmentor as JaxSAMSegmentor
from sam6d_tpu.weights.convert_dinov2 import convert_dinov2_state_dict
from sam6d_tpu.weights.convert_pem import convert_pem_state_dict
from sam6d_tpu.weights.convert_sam import convert_sam_state_dict
from sam6d_torch.core.numerics import BUDGETS, q99_rel, rotation_q99
from sam6d_torch.core.params import cast_float_params
from sam6d_torch.kernels import attention, attention_qkv, attention_relpos, factored
from sam6d_torch.models import ism_scoring
from sam6d_torch.models.dinov2 import DINOv2
from sam6d_torch.models.pem import PEMNet
from sam6d_torch.models.sam import SAM
from sam6d_torch.pipelines import demo as demo_mod
from sam6d_torch.pipelines.fastsam import FastSAMSegmentor
from sam6d_torch.pipelines.ism import ISMPipeline
from sam6d_torch.pipelines.pem import PEMPipeline
from sam6d_torch.pipelines.sam_amg import SAMSegmentor

from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import tiny_cfg, tiny_ism_cfgs, tiny_sam_cfgs
from torch_port_draw import conditioned_pem_state_dict, posed_pem_frame, rand_like_state_dict

BF = torch.bfloat16
JBF = ml_dtypes.bfloat16
# the JAX package's tolerance for its bf16 kernels against the bf16 contract
# (tests/test_pallas_kernels.py:159, :205): the bf16 output's rounding
KERNEL_ATOL = 8e-3
# the port's bf16 error against JAX fp32 may be at most this multiple of
# JAX's own bf16 error, and never needs to be below the floor
FP32_FACTOR, FP32_FLOOR = 2.0, 1e-3


def f32(x):
    """numpy float32 of a torch or JAX array of any float dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x).astype(np.float32)


def t16(x):
    """numpy / JAX bf16 array -> torch bf16 tensor (values exact)."""
    return torch.from_numpy(np.asarray(x).astype(np.float32)).to(BF)


def check_stage(name, port16, jax16, jax32, metric=q99_rel):
    """The two bounds of a stage; returns the three errors."""
    to_jax16, to_jax32, jax_own = (metric(port16, jax16), metric(port16, jax32),
                                   metric(jax16, jax32))
    bound = max(FP32_FACTOR * jax_own, FP32_FLOOR)
    assert to_jax16 <= BUDGETS[name], (name, to_jax16, BUDGETS[name])
    assert to_jax32 <= bound, (name, to_jax32, jax_own)
    return to_jax16, to_jax32, jax_own


def drawn(net, seed):
    """Fan-in-scaled random weights for `net` (float32, CPU) and their numpy
    copy for the JAX converters."""
    sd = rand_like_state_dict(net, seed)
    return sd, {k: v.numpy() for k, v in sd.items()}


# ------------------------------------------------------------ params


def test_cast_float_params_matches_jax():
    """Every floating tensor cast, integer and bool tensors left as they are:
    dtypes leaf by leaf and values exactly as the JAX function's; a module
    is cast in place, its integer buffers untouched."""
    rng = np.random.RandomState(0)
    tree = {"w": rng.randn(3, 4).astype(np.float32), "b": rng.randn(4).astype(np.float32),
            "h": rng.randn(5).astype(np.float16), "s": np.float32(0.3),
            "i": np.arange(6, dtype=np.int32), "n": np.array(3, np.int32),
            "m": rng.rand(4) > 0.5}
    want = jax_cast_float_params({k: jnp.asarray(v) for k, v in tree.items()}, jnp.bfloat16)
    got = cast_float_params({k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}, BF)
    assert set(got) == set(want)
    for k in tree:
        w = np.asarray(want[k])
        assert str(got[k].dtype).split(".")[-1] == str(w.dtype), (k, got[k].dtype, w.dtype)
        np.testing.assert_array_equal(f32(got[k]) if got[k].is_floating_point()
                                      else got[k].numpy(), w.astype(np.float32)
                                      if w.dtype == JBF else w, err_msg=k)
    net = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.BatchNorm1d(3))
    assert cast_float_params(net, BF) is net
    assert all(p.dtype == BF for p in net.parameters())
    assert net[1].running_var.dtype == BF and net[1].num_batches_tracked.dtype == torch.int64


@pytest.mark.parametrize("net", ["SAM", "DINOv2", "PEMNet"])
def test_fan_in_draw_is_rand_like_tree_on_the_flax_tree(net, monkeypatch):
    """With every normal draw replaced by 1, the port's draw carried to JAX
    by the converter gives each flax leaf rand_like_tree's value for its
    shape: 1.05 for a leaf of one or no axis, else 1 / sqrt(the product of
    all axes but the last) (scanned stacks included; zeros only where the
    converter pads)."""
    monkeypatch.setattr(torch, "randn", lambda *shape, generator=None, device=None,
                        dtype=None: torch.ones(*shape, device=device, dtype=dtype))
    if net == "SAM":
        _, pcfg = tiny_sam_cfgs()
        with torch.device("meta"):
            meta = SAM(pcfg)
        tree = convert_sam_state_dict(
            {k: v.numpy() for k, v in rand_like_state_dict(meta, 0).items()},
            depth=pcfg.encoder_depth, grid=pcfg.img_size // pcfg.patch_size)
    elif net == "DINOv2":
        d = tiny_ism_cfgs()[1].dinov2
        with torch.device("meta"):
            meta = DINOv2(d.img_size, d.patch_size, d.embed_dim, d.depth, d.num_heads)
        tree = convert_dinov2_state_dict(
            {k: v.numpy() for k, v in rand_like_state_dict(meta, 0).items()},
            depth=d.depth, target_grid=d.img_size // d.patch_size)
    else:
        cfg = tiny_cfg()
        with torch.device("meta"):
            meta = PEMNet(cfg)
        tree = convert_pem_state_dict(
            {k: v.numpy() for k, v in rand_like_state_dict(meta, 0).items()},
            vit_depth=cfg.vit.depth, coarse_nblock=cfg.coarse.nblock,
            fine_nblock=cfg.fine.nblock)
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        leaf = np.asarray(leaf)
        if not np.issubdtype(leaf.dtype, np.floating):
            continue
        want = 1.05 if leaf.ndim <= 1 else float(np.prod(leaf.shape[:-1])) ** -0.5
        vals = np.unique(leaf[leaf != 0])
        np.testing.assert_allclose(vals, want, rtol=1e-6, err_msg=jax.tree_util.keystr(path))
        n += 1
    assert n >= 10


# ------------------------------------------------------------ kernels


def _kernel_case(name, rng):
    """(port output, Pallas output) on one set of bf16 inputs."""
    if name in ("K1-global", "K1-windowed"):
        B, (H, W), heads, hd = (1, (8, 8), 2, 16) if name == "K1-global" else (3, (7, 7), 2, 16)
        N, C = H * W, heads * hd
        qkv = (rng.randn(B, N, 3 * C) * 0.5).astype(JBF)
        rh = (rng.randn(2 * H - 1, hd) * 0.3).astype(JBF)
        rw = (rng.randn(2 * W - 1, hd) * 0.3).astype(JBF)
        qj = jnp.asarray(qkv).reshape(B, N, 3, heads, hd).transpose(2, 0, 3, 1, 4)
        want = jfa.flash_attention_relpos(qj[0], qj[1], qj[2], jnp.asarray(rh), jnp.asarray(rw),
                                          (H, W), interpret=True)
        want = f32(want).transpose(0, 2, 1, 3).reshape(B, N, C)
        return attention_relpos.flash_attention_relpos(t16(qkv), t16(rh), t16(rw), (H, W),
                                                       heads), want
    if name == "K5":
        B, N, heads, hd = 2, 57, 4, 64
        qkv = (rng.randn(B, N, 3 * heads * hd) * 0.5).astype(JBF)
        want = jfa.fused_attention_qkv(jnp.asarray(qkv), heads, scale=hd ** -0.5,
                                       interpret=True)
        return attention_qkv.fused_attention_qkv(t16(qkv), heads, hd ** -0.5), f32(want)
    B, H, Nq, Nk, hd = {"K8": (2, 4, 61, 61, 32), "K8-cross": (2, 4, 61, 300, 32),
                        "K9": (2, 4, 57, 57, 64)}[name]
    q, k = ((rng.randn(B, H, n, hd) * 0.5).astype(JBF) for n in (Nq, Nk))
    v = rng.randn(B, H, Nk, hd).astype(JBF)
    jfn, pfn = ((jfa.fused_attention_small, attention.fused_attention_small) if name == "K9"
                else (jfa.fused_attention, attention.fused_attention))
    want = jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=hd ** -0.5,
               interpret=True)
    return pfn(t16(q), t16(k), t16(v), hd ** -0.5), f32(want)


@pytest.mark.parametrize("name", ["K1-global", "K1-windowed", "K5", "K8", "K8-cross", "K9"])
def test_plain_bf16_kernels_match_pallas(name):
    """The dispatches on bf16 CPU tensors take the plain versions of the bf16
    entries; held to the JAX Pallas kernels in interpret mode on the same
    bf16 inputs (K1: 8x8 global, windowed 7x7; K8 also cross-attention)."""
    got, want = _kernel_case(name, np.random.RandomState(11))
    assert got.dtype == BF
    np.testing.assert_allclose(f32(got), want, atol=KERNEL_ATOL, rtol=0)


def test_dispatches_refuse_float16_and_mixed_dtypes():
    q = torch.zeros(1, 2, 9, 16)
    qkv = torch.zeros(1, 9, 3 * 32)
    rh, rw = torch.zeros(5, 8), torch.zeros(5, 8)
    for dt in (torch.float16, torch.float64):
        with pytest.raises(ValueError):
            attention.fused_attention(q.to(dt), q.to(dt), q.to(dt), 0.25)
        with pytest.raises(ValueError):
            attention.fused_attention_small(q.to(dt), q.to(dt), q.to(dt), 0.25)
        with pytest.raises(ValueError):
            attention_qkv.fused_attention_qkv(qkv.to(dt), 1, 0.125)
        with pytest.raises(ValueError):
            attention_relpos.flash_attention_relpos(qkv.to(dt), rh.to(dt), rw.to(dt),
                                                    (3, 3), 4)
    with pytest.raises(ValueError):
        attention.fused_attention(q, q.to(BF), q, 0.25)
    with pytest.raises(ValueError):
        attention.fused_attention_small(q.to(BF), q.to(BF), q, 0.25)
    with pytest.raises(ValueError):
        attention_relpos.flash_attention_relpos(qkv.to(BF), rh, rw, (3, 3), 4)


def test_bf16_cuda_entries_refuse_cpu_tensors_and_count_only_launches():
    entries = (attention.fused_attention_bf16_cuda, attention.fused_attention_small_bf16_cuda,
               attention_qkv.fused_attention_qkv_bf16_cuda,
               attention_relpos.flash_attention_relpos_bf16_cuda,
               factored.factored_ln_stats_bf16_cuda, factored.factored_t2i_attention_bf16_cuda,
               factored.factored_i2t_scores_bf16_cuda)
    counts = [f.launches for f in entries]
    q = torch.zeros(1, 2, 9, 16, dtype=BF)
    qkv = torch.zeros(1, 9, 3 * 32, dtype=BF)
    rh, rw = torch.zeros(5, 8, dtype=BF), torch.zeros(5, 8, dtype=BF)
    for fn in entries[:2]:
        with pytest.raises(ValueError):
            fn(q, q, q, 0.25)
    with pytest.raises(ValueError):
        entries[2](torch.zeros(1, 5, 3 * 64, dtype=BF), 1, 0.125)
    with pytest.raises(ValueError):
        entries[3](qkv, rh, rw, (3, 3), 4)
    # K2-K4 at their kernels' widths: 256 channels, 8 heads of 16
    blocks = ((torch.rand(1, 3, 8, dtype=BF), torch.rand(1, 8, dtype=BF)),)
    U, S = torch.zeros(1, 3, 256, dtype=BF), torch.zeros(8, 256, dtype=BF)
    a = torch.ones(1, 8, dtype=BF)
    kt, uk = torch.zeros(1, 7, 128, dtype=BF), torch.zeros(1, 3, 128, dtype=BF)
    ks = torch.zeros(8, 128, dtype=BF)
    with pytest.raises(ValueError):
        entries[4](blocks, U, S, a)
    with pytest.raises(ValueError):
        entries[5](kt, uk, uk, blocks, a, ks, ks, ks, 8)
    with pytest.raises(ValueError):
        entries[6](kt, uk, blocks, a, ks, ks, 8)
    attention.fused_attention(q, q, q, 0.25)              # CPU: plain versions
    attention.fused_attention_small(q, q, q, 0.25)
    attention_qkv.fused_attention_qkv(torch.zeros(1, 5, 3 * 64, dtype=BF), 1, 0.125)
    attention_relpos.flash_attention_relpos(qkv, rh, rw, (3, 3), 4)
    factored.factored_ln_stats(blocks, U, S, a)
    factored.factored_t2i_attention(kt, uk, uk, blocks, a, ks, ks, ks, 8)
    factored.factored_i2t_scores(kt, uk, blocks, a, ks, ks, 8)
    assert counts == [f.launches for f in entries]


# ------------------------------------------------------------ SAM stages


@pytest.fixture(scope="module")
def sam_stage():
    """JAX's SAM segmentors in fp32 and bf16 and the port's in bf16, on one
    set of fan-in-scaled weights; the encoder run on one seeded batch."""
    jcfg, pcfg = tiny_sam_cfgs()
    with torch.device("meta"):
        meta = SAM(pcfg)
    sd, sd_np = drawn(meta, 1)
    variables = convert_sam_state_dict(sd_np, depth=pcfg.encoder_depth,
                                       grid=pcfg.img_size // pcfg.patch_size)
    j32 = JaxSAMSegmentor(jcfg, variables=variables)
    j16 = JaxSAMSegmentor(jcfg, variables=variables, dtype=jnp.bfloat16)
    port = SAMSegmentor(pcfg, state_dict=sd, device="cpu", dtype=BF)
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    e32 = j32.encoder.apply(j32.vars["image_encoder"], jnp.asarray(x))
    e16 = j16.encoder.apply(j16.vars["image_encoder"], jnp.asarray(x).astype(jnp.bfloat16))
    return j32, j16, port, x, e32, e16


def test_sam_encoder_bf16_within_budget(sam_stage):
    j32, j16, port, x, e32, e16 = sam_stage
    assert all(p.dtype == BF for p in port.sam.parameters())
    with torch.no_grad():
        got = port.sam.image_encoder(torch.from_numpy(x))
    assert got.dtype == BF and got.shape == e32.shape
    check_stage("sam_encode", f32(got), f32(e16), f32(e32))


def _jax_decode(seg, emb, pts, iou_only=False):
    v = seg.vars
    dense_pe = seg.prompt_encoder.apply(v["prompt_encoder"], method="dense_pe")
    sparse, dense = seg.prompt_encoder.apply(v["prompt_encoder"], pts[:, None, :],
                                             jnp.ones((pts.shape[0], 1), jnp.int32))
    return seg.mask_decoder.apply(v["mask_decoder"], emb[0], dense_pe, sparse, dense,
                                  iou_only=iou_only)


@pytest.mark.parametrize("iou_only", [False, True])
def test_sam_decode_bf16_within_budget(sam_stage, iou_only):
    """A chunk of 16 point prompts on JAX's own embeddings (bf16 for the bf16
    runs): the standard decode's masks and IoU, and the factored iou_only
    pass (its K2-K4 through their plain bf16 versions) against JAX's (its
    XLA branch on the CPU)."""
    j32, j16, port, _, e32, e16 = sam_stage
    pts = np.random.RandomState(3).rand(16, 2).astype(np.float32) * 64
    m32, iou32 = _jax_decode(j32, e32, jnp.asarray(pts), iou_only)
    m16, iou16 = _jax_decode(j16, e16, jnp.asarray(pts), iou_only)
    sam = port.sam
    with torch.no_grad():
        pts_t = torch.from_numpy(pts)[:, None, :]
        sparse, dense = sam.prompt_encoder(pts_t, torch.ones(16, 1, dtype=torch.int64))
        masks, iou = sam.mask_decoder(t16(e16)[0], sam.prompt_encoder.dense_pe(), sparse,
                                      dense, iou_only=iou_only)
    assert iou.dtype == BF
    check_stage("amg_decode_iou", f32(iou), f32(iou16), f32(iou32))
    if not iou_only:
        check_stage("amg_decode_masks", f32(masks),
                    f32(jsam.block_masks_to_rowmajor(m16)),
                    f32(jsam.block_masks_to_rowmajor(m32)))


# ---------------------------------------------------- DINOv2, ISM scores


@pytest.fixture(scope="module")
def dino_stage():
    """JAX's DINOv2 in fp32 and bf16 (as bf16_budget.py builds it) and the
    port's ISM pipeline DINOv2 in bf16 (LayerNorm affines folded in fp32,
    then cast; K5's bf16 plain version), on one set of weights and crops."""
    _, pcfg = tiny_ism_cfgs()
    d = pcfg.dinov2
    with torch.device("meta"):
        meta = DINOv2(d.img_size, d.patch_size, d.embed_dim, d.depth, d.num_heads)
    sd, sd_np = drawn(meta, 2)
    vars32 = convert_dinov2_state_dict(sd_np, depth=d.depth,
                                       target_grid=d.img_size // d.patch_size)
    vars16 = jax_cast_float_params(vars32, jnp.bfloat16)

    def net(dtype):
        return JaxDINOv2(img_size=d.img_size, patch_size=d.patch_size, embed_dim=d.embed_dim,
                         depth=d.depth, num_heads=d.num_heads, dtype=dtype)
    crops = np.random.RandomState(4).rand(16, d.img_size, d.img_size, 3).astype(np.float32)
    out32 = net(jnp.float32).apply(vars32, jnp.asarray(crops))
    out16 = net(jnp.bfloat16).apply(vars16, jnp.asarray(crops).astype(jnp.bfloat16))
    pipe = ISMPipeline(pcfg, state_dict=sd, device="cpu", dtype=BF)
    with torch.no_grad():
        got = pipe.dinov2(torch.from_numpy(crops))
    return pipe, out32, out16, got


def test_dinov2_bf16_within_budget(dino_stage):
    pipe, (cls32, p32), (cls16, p16), (cls, patch) = dino_stage
    assert all(p.dtype == BF for p in pipe.dinov2.parameters())
    assert cls.dtype == patch.dtype == BF
    check_stage("dinov2_cls", f32(cls), f32(cls16), f32(cls32))
    check_stage("dinov2_patch", f32(patch), f32(p16), f32(p32))


def test_ism_scores_bf16_within_budget(dino_stage):
    """Semantic scores of 32 query descriptors against 8 reference views
    (bf16_budget.py's avg-5): JAX scores its bf16 descriptors in bf16, the
    port scores the same descriptors in fp32 (its scoring island)."""
    _, (cls32, _), (cls16, _), _ = dino_stage
    T = 8
    valid = np.ones(32, bool)

    def jax_score(q, ref):
        return jax_scoring.semantic_scores(q, ref, jnp.asarray(valid), "avg_5", 0.2)["score"]
    s32 = jax_score(jnp.concatenate([cls32] * 2), cls32[:T][None])
    s16 = jax_score(jnp.concatenate([cls16] * 2), cls32[:T][None].astype(jnp.bfloat16))
    got = ism_scoring.semantic_scores(
        t16(np.concatenate([np.asarray(cls16)] * 2)).float(),
        t16(np.asarray(cls32[:T][None]).astype(JBF)).float(), torch.from_numpy(valid),
        "avg_5", 0.2)["score"]
    assert got.dtype == torch.float32
    check_stage("ism_scores", f32(got), f32(s16), f32(s32))


# ------------------------------------------------------------ PEM stage


def _jax_fine_half(cfg, dtype, variables, inputs, R0, t0):
    """JAX's PEM fine half (trunk, fine positional encodings, fine matching,
    compute_fine_Rt) from the pose (R0, t0 in metres), composed from its own
    modules as its `infer` composes them after the coarse solve."""
    from sam6d_tpu.ops.geometry import inverse_transform_points
    from sam6d_tpu.pose.solvers import compute_fine_Rt
    net = JaxPEMNet(cfg, dtype=dtype)
    tr = net.apply(variables, inputs, method="_shared_trunk")
    den = tr["radius"][:, None] + 1e-6

    def atten(m, tr, R0, t0):
        pe1 = m.fine_pe(inverse_transform_points(tr["dense_pm"], R0, t0))
        return m.fine_point_matching(pe1, tr["dense_fm"], tr["geo_m"], tr["fps_idx_m"],
                                     m.fine_pe(tr["dense_po"]), tr["dense_fo"], tr["geo_o"],
                                     tr["fps_idx_o"])[-1]
    R, t, score = compute_fine_Rt(net.apply(variables, tr, R0, t0 / den, method=atten),
                                  tr["dense_pm"], tr["dense_po"],
                                  inputs["model"] / den[..., None], dis_thres=cfg.dis_thres)
    return R, t * den, score


def test_pem_fine_half_bf16():
    """PEM's fine half in both packages at the tiny configuration, batch 8,
    on a posed frame (torch_port_draw.posed_pem_frame: the template is the
    observed cloud under a known pose) with the conditioned draw
    (torch_port_draw.conditioned_pem_state_dict), from one pose 8 degrees
    and ~5 mm off the frame's own. (The coarse half's random numbers cannot
    match across the frameworks.) Both packages' fp32 poses recover the
    frame's within 2 degrees, so the stages compare against an answer; R by
    its geodesic angle, t and the pose score by q99_rel, each held to the
    stage's budget of JAX's bf16 output and to the bound against JAX's fp32
    output (check_stage)."""
    from scipy.spatial.transform import Rotation
    cfg = tiny_cfg()
    with torch.device("meta"):
        meta = PEMNet(cfg)
    sd = conditioned_pem_state_dict(rand_like_state_dict(meta, 3))
    vars32 = convert_pem_state_dict({k: v.numpy() for k, v in sd.items()},
                                    vit_depth=cfg.vit.depth, coarse_nblock=cfg.coarse.nblock,
                                    fine_nblock=cfg.fine.nblock)
    vars16 = jax_cast_float_params(vars32, jnp.bfloat16)
    rng = np.random.RandomState(5)

    def features(rgb, choose):
        return JaxPEMNet(cfg).apply(vars32, jnp.asarray(rgb), jnp.asarray(choose),
                                    method="extract_img_feats")
    B = 8
    inputs, R_true, t_true = posed_pem_frame(rng, cfg, B, features)
    axis = rng.randn(B, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    R0 = (Rotation.from_rotvec(axis * np.radians(8.0))
          * Rotation.from_matrix(R_true)).as_matrix().astype(np.float32)
    t0 = (t_true + rng.randn(B, 3) * 0.003).astype(np.float32)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    R32, t32, s32 = _jax_fine_half(cfg, jnp.float32, vars32, jin, jnp.asarray(R0),
                                   jnp.asarray(t0))
    R16, t16_, s16 = _jax_fine_half(cfg, jnp.bfloat16, vars16, jin, jnp.asarray(R0),
                                    jnp.asarray(t0))
    pipe = PEMPipeline(cfg, state_dict=sd, device="cpu", dtype=BF)
    assert all(p.dtype == BF for p in pipe.net.parameters())
    with torch.no_grad():
        tr = pipe.net._shared_trunk({k: torch.from_numpy(v) for k, v in inputs.items()})
        den = tr["radius"][:, None] + 1e-6
        R, t, score = pipe.net.infer_fine(tr, torch.from_numpy(inputs["model"]) / den[..., None],
                                          torch.from_numpy(R0), torch.from_numpy(t0) / den)
    assert tr["dense_fm"].dtype == BF and R.dtype == t.dtype == score.dtype == torch.float32
    assert 180.0 * rotation_q99(f32(R32), R_true) <= 2.0
    check_stage("pem_R", f32(R), f32(R16), f32(R32), metric=rotation_q99)
    check_stage("pem_t", f32(t * den), f32(t16_), f32(t32))
    check_stage("pem_score", f32(score), f32(s16), f32(s32))


def test_k1_bf16_tables_in_kernel_order_within_an_ulp_of_the_einsum():
    """The K1 bf16 tables of the plain version, summed in the kernel's order,
    against the einsum's tables rounded to bf16: equal but where the two
    orders round an entry to neighbouring bf16 values, one ulp apart (the
    entries reach |4..8| at rel-pos x3, where an ulp is 2^-5)."""
    rng = np.random.RandomState(26)
    B, (H, W), heads, hd = 2, (7, 7), 2, 80
    C = heads * hd
    qkv = t16(rng.randn(B, H * W, 3 * C).astype(np.float32))
    rh = t16(rng.randn(2 * H - 1, hd).astype(np.float32) * 0.3)
    rw = t16(rng.randn(2 * W - 1, hd).astype(np.float32) * 0.3)
    got = attention_relpos.bf16_rel_pos_tables(qkv, rh, rw, (H, W), heads)
    want = attention_relpos.rel_pos_tables(qkv.float(), rh.float(), rw.float(), (H, W), heads)
    for g, w in zip(got, want):
        w16 = w.to(BF).float()
        assert g.shape == w16.shape and bool((g == g.to(BF).float()).all())
        ulp = 2.0 ** (torch.floor(torch.log2(torch.maximum(g.abs(), w16.abs()))) - 7)
        assert bool(((g - w16).abs() <= ulp).all())
        assert float(w.abs().max()) > 4.0


# ------------------------------------------------------ composed frames


@pytest.fixture(scope="module")
def frame_weights():
    """Seeded tiny SAM (blocky masks, so NMS keeps several proposals),
    DINOv2 and PEM weights, as test_torch_port_frame.py draws them."""
    from sam6d_torch.weights.pem import pem_state_dict_from_flax
    from torch_port_common import jax_variables, tiny_dinov2_weights, tiny_sam_weights
    _, psam = tiny_sam_cfgs()
    _, sam_sd = tiny_sam_weights(psam, seed=1, rng=np.random.RandomState(1),
                                 blocky_masks=True)
    _, pism = tiny_ism_cfgs()
    dino_sd, _ = tiny_dinov2_weights(pism, rng=np.random.RandomState(2))
    pem_cfg = tiny_cfg()
    _, pem_vars = jax_variables(pem_cfg)
    return dict(sam_sd=sam_sd, dino_sd=dino_sd, pem_cfg=pem_cfg,
                pem_sd=pem_state_dict_from_flax(pem_vars))


def _all_params(*nets):
    return [p for n in nets for p in list(n.parameters()) + list(n.buffers())
            if p.is_floating_point()]


def test_composed_bf16_frame_through_run_demo(frame_weights, tmp_path, monkeypatch):
    """run_demo with Config(dtype="bfloat16") on one frame: SAM -> ISM -> PEM
    in bf16 (every floating parameter and buffer of the three networks
    bf16), every output file written, finite scores, orthonormal rotations,
    finite translations."""
    from sam6d_torch.data.mesh import load_ply
    from sam6d_torch.render.templates import render_templates
    from test_torch_port_frame import _configs, _write_frame
    _, pcfg = _configs()
    pcfg = dataclasses.replace(pcfg, dtype="bfloat16")
    files = _write_frame(tmp_path, np.random.RandomState(8))
    render_templates(load_ply(files[0]), str(tmp_path), image_size=64, device="cpu")
    made = []
    for name in ("SAMSegmentor", "ISMPipeline", "PEMPipeline"):
        cls = getattr(demo_mod, name)
        monkeypatch.setattr(demo_mod, name,
                            lambda *a, _cls=cls, **k: made.append(_cls(*a, **k)) or made[-1])
    w = frame_weights
    got = demo_mod.run_demo(pcfg, *files, str(tmp_path), dinov2_state_dict=w["dino_sd"],
                            sam_state_dict=w["sam_sd"], pem_state_dict=w["pem_sd"],
                            det_score_thresh=-1.0, skip_render=True, device="cpu")
    seg, ism, pem = made
    params = _all_params(seg.sam, ism.dinov2, pem.net)
    assert params and all(p.dtype == BF for p in params)
    for name in ("detection_ism.json", "vis_ism.png", "detection_pem.json"):
        assert (tmp_path / "sam6d_results" / name).exists(), name
    assert len(got["ism"]) >= 2 and len(got["pem"]) >= 1
    assert all(np.isfinite(r["score"]) for r in got["ism"] + got["pem"])
    for r in got["pem"]:
        R = np.asarray(r["R"])
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
        assert np.isfinite(r["t"]).all()


def test_composed_bf16_frame_through_the_stream(frame_weights, tmp_path):
    """MultiObjectStream over bf16 pipelines: one object onboarded, one frame
    in flight and one completed; poses finite and orthonormal."""
    from sam6d_torch.pipelines.streaming import MultiObjectStream
    from test_torch_port_ism_slice import K_CAM, _template_dir
    w = frame_weights
    _, psam = tiny_sam_cfgs()
    _, pism = tiny_ism_cfgs()
    seg = SAMSegmentor(psam, state_dict=w["sam_sd"], device="cpu", dtype=BF)
    ism = ISMPipeline(pism, state_dict=w["dino_sd"], device="cpu", segmentor=seg, dtype=BF)
    pem = PEMPipeline(w["pem_cfg"], state_dict=w["pem_sd"], device="cpu", dtype=BF)
    rng = np.random.RandomState(7)
    tdir = _template_dir(tmp_path, rng)
    for v in range(42):
        np.save(str(pathlib.Path(tdir) / f"xyz_{v}.npy"),
                (rng.rand(32, 32, 3).astype(np.float32) - 0.5) * 100)
    stream = MultiObjectStream(ism, pem, det_score_thresh=-1.0)
    model = (rng.rand(w["pem_cfg"].n_sample_model_point, 3).astype(np.float32) - 0.5) * 0.08
    stream.onboard_object(7, tdir, model)
    frame = ((rng.rand(48, 64, 3) * 255).astype(np.uint8),
             (rng.rand(48, 64) * 400 + 400).astype(np.float32), K_CAM, 1.0)
    out = list(stream.process_stream(iter([frame, frame]), depth_in_flight=1))
    assert len(out) == 2 and all(p.dtype == BF for p in _all_params(seg.sam, ism.dinov2,
                                                                     pem.net))
    poses = [p for o in out for p in o["poses"]]
    assert poses
    for p in poses:
        R = np.asarray(p["R"])
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
        assert np.isfinite(p["t"]).all() and np.isfinite(p["score"])


def test_predictor_on_a_bf16_segmentor(frame_weights):
    """SAMPredictor on a bf16 segmentor: a point, a box and a mask-fed
    prompt give float32 host arrays, finite, of the float32 predictor's
    shapes."""
    from sam6d_torch.pipelines.predictor import SAMPredictor
    _, psam = tiny_sam_cfgs()
    image = (np.random.RandomState(10).rand(48, 64, 3) * 255).astype(np.uint8)
    outs = {}
    for dt in (torch.float32, BF):
        pred = SAMPredictor(SAMSegmentor(psam, state_dict=frame_weights["sam_sd"],
                                         device="cpu", dtype=dt))
        pred.set_image(image)
        m, iou, low = pred.predict(np.array([[20.0, 30.0]]), np.array([1]))
        m2, iou2, _ = pred.predict(box=np.array([5.0, 5.0, 40.0, 30.0]), mask_input=low[:1],
                                   multimask_output=False, return_logits=True)
        outs[dt] = (m, iou, low, m2, iou2)
    for a, b in zip(outs[torch.float32], outs[BF]):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert b.dtype == bool or (b.dtype == np.float32 and np.isfinite(b).all())


def test_pipelines_without_dtype_stay_float32_bit_for_bit(frame_weights):
    """Built without `dtype`, the four pipelines hold float32 parameters and
    give what the float32 modules built from the same weights give, bit for
    bit (the parity tests of the other files hold those to JAX)."""
    w = frame_weights
    _, psam = tiny_sam_cfgs()
    _, pism = tiny_ism_cfgs()
    seg = SAMSegmentor(psam, state_dict=w["sam_sd"], device="cpu")
    ism = ISMPipeline(pism, state_dict=w["dino_sd"], device="cpu")
    pem = PEMPipeline(w["pem_cfg"], state_dict=w["pem_sd"], device="cpu")
    fs = FastSAMSegmentor(seed=1, device="cpu", widths=(8, 16, 32, 64, 64),
                          depths=(1, 1, 1, 1))
    assert all(p.dtype == torch.float32
               for p in _all_params(seg.sam, ism.dinov2, pem.net, fs.net))
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32))
    ref_sam = SAM(psam)
    ref_sam.load_state_dict(w["sam_sd"])
    with torch.no_grad():
        assert torch.equal(seg.sam.image_encoder(x), ref_sam.image_encoder(x))
        d = pism.dinov2
        crops = torch.from_numpy(rng.rand(2, d.img_size, d.img_size, 3).astype(np.float32))
        ref_dino = DINOv2(d.img_size, d.patch_size, d.embed_dim, d.depth, d.num_heads,
                          use_flash=True, ln_folded=True)
        from sam6d_torch.models.dinov2 import fold_ln_affine
        ref_dino.load_state_dict(fold_ln_affine(w["dino_sd"]))
        for a, b in zip(ism.dinov2(crops), ref_dino(crops)):
            assert torch.equal(a, b)
        ref_pem = PEMNet(w["pem_cfg"])
        ref_pem.load_state_dict(w["pem_sd"])
        S = w["pem_cfg"].img_size
        rgb = torch.from_numpy(rng.rand(2, S, S, 3).astype(np.float32))
        choose = torch.from_numpy(rng.randint(0, S * S, (2, 40)))
        assert torch.equal(pem.net.extract_img_feats(rgb, choose),
                           ref_pem.extract_img_feats(rgb, choose))
