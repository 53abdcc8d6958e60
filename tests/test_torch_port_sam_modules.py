"""The modules of the port's SAM segmentor against the JAX package on the
CPU, at tiny widths, on one set of seeded weights carried across by the
converters: the image encoder, the prompt encoder, the mask decoder (the
standard decode and the factored `iou_only` pass, in float32 and in bf16
against the JAX package's bf16 kernel path), the rel-pos attention
(K1) and the three factored kernels (K2-K4) as plain versions against the
Pallas kernels in interpret mode, mask boxes, the top-k tie rule, and the
SAM weights bridge."""
import copy

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sam6d_tpu.core.params import cast_float_params as jax_cast_float_params
from sam6d_tpu.kernels import factored_t2i as jfac
from sam6d_tpu.kernels.flash_attention import flash_attention_relpos as jax_relpos
from sam6d_tpu.models import sam as jsam
from sam6d_tpu.ops import masks as jmasks
from sam6d_tpu.weights.convert_sam import convert_sam_state_dict
from sam6d_torch.core.numerics import BUDGETS, q99_rel
from sam6d_torch.core.params import cast_float_params
from sam6d_torch.kernels import attention_relpos, factored
from sam6d_torch.models import sam
from sam6d_torch.ops import masks
from sam6d_torch.pipelines.sam_amg import stable_top_k
from sam6d_torch.weights.sam import (load_reference_checkpoint,
                                     random_sam_state_dict,
                                     sam_state_dict_from_flax)

from torch_port_common import one_torch_thread  # noqa: F401 (autouse: one torch thread)
from torch_port_common import close, tiny_sam_cfgs, tiny_sam_weights, tt

# the JAX package's own tolerances: its encoder test against the torch
# oracle (3e-4) and its rel-pos kernel test (2e-5); 1e-4 elsewhere, float32
# sums in another order
ENCODER_ATOL = 3e-4
RELPOS_ATOL = 2e-5


@pytest.fixture(scope="module")
def weights():
    jcfg, pcfg = tiny_sam_cfgs()
    variables, sd = tiny_sam_weights(pcfg, rng=np.random.RandomState(1))
    net = sam.SAM(pcfg)
    net.load_state_dict(sd, strict=True)
    return jcfg, pcfg, variables, net.eval()


def test_image_encoder_matches_jax(weights):
    """Window 3 on the 4x4 grid: the windowed blocks pad 4 -> 6 after norm1
    and attend over the zero pad tokens; block 1 is global."""
    jcfg, _, variables, net = weights
    enc = jsam.SAMImageEncoder(img_size=64, patch_size=16, embed_dim=32, depth=3,
                               num_heads=4, window_size=3, global_attn_indexes=(1,),
                               out_chans=32)
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    want = enc.apply(variables["image_encoder"], jnp.asarray(x))
    with torch.no_grad():
        got = net.image_encoder(torch.from_numpy(x))
    assert got.shape == (2, 4, 4, 32)
    close(got, want, atol=ENCODER_ATOL, rtol=0)
    assert tuple(net.image_encoder.blocks[0].attn.rel_pos_h.shape) == (5, 8)
    assert tuple(net.image_encoder.blocks[1].attn.rel_pos_h.shape) == (7, 8)


def test_prompt_encoder_matches_jax(weights):
    _, _, variables, net = weights
    pe = jsam.PromptEncoder(embed_dim=32, input_image_size=(64, 64),
                            image_embedding_size=(4, 4))
    v = variables["prompt_encoder"]
    rng = np.random.RandomState(3)
    pts = (rng.rand(5, 1, 2) * 64).astype(np.float32)
    lbl = rng.randint(-1, 2, (5, 1)).astype(np.int32)
    boxes = (rng.rand(5, 4) * 64).astype(np.float32)
    m = rng.randn(3, 16, 16, 1).astype(np.float32)
    p = net.prompt_encoder
    with torch.no_grad():
        close(p.embed_points(tt(pts), tt(lbl).long()),
              pe.apply(v, pts, lbl, method="embed_points"))
        close(p.dense_pe(), pe.apply(v, method="dense_pe"))
        close(p.no_mask_dense(), pe.apply(v, method="no_mask_dense"))
        close(p.embed_boxes(tt(boxes)), pe.apply(v, boxes, method="embed_boxes"))
        close(p.embed_masks(tt(m)), pe.apply(v, m, method="embed_masks"))
        sparse, dense = p(tt(pts), tt(lbl).long(), tt(boxes), tt(m))
    want_s, want_d = pe.apply(v, pts, lbl, boxes, m)
    close(sparse, want_s)
    close(dense, want_d)


def _decoder_inputs(B=6, g=8, C=32):
    rng = np.random.RandomState(4)
    return tuple(rng.randn(*s).astype(np.float32) * 0.3
                 for s in ((g, g, C), (g, g, C), (B, 2, C), (g, g, C)))


def test_mask_decoder_matches_jax(weights):
    """The standard decode (row-major upscale GEMMs) against the JAX
    package's block-layout decode, and the factored iou_only pass against
    its XLA branch and against the full decode's IoU."""
    _, _, variables, net = weights
    v = variables["mask_decoder"]
    inputs = _decoder_inputs()
    dec = jsam.MaskDecoder(transformer_dim=32, block_layout=True, block_masks=True)
    want_m, want_iou = dec.apply(v, *map(jnp.asarray, inputs))
    _, want_iou_only = dec.apply(v, *map(jnp.asarray, inputs), iou_only=True)
    with torch.no_grad():
        got_m, got_iou = net.mask_decoder(*map(tt, inputs))
        none_m, got_iou_only = net.mask_decoder(*map(tt, inputs), iou_only=True)
    assert none_m is None and got_m.shape == (6, 4, 32, 32)
    close(got_m, jsam.block_masks_to_rowmajor(want_m))
    close(got_iou, want_iou)
    close(got_iou_only, want_iou_only)
    close(got_iou_only, got_iou)


def test_iou_only_matches_jax_factored_kernels_in_interpret_mode(weights):
    """The JAX decoder with its three Pallas kernels (interpret mode) and
    the port's iou_only pass, whose K2-K4 dispatches take the plain versions
    on the CPU."""
    _, _, variables, net = weights
    inputs = _decoder_inputs(B=5)
    dec_k = jsam.MaskDecoder(transformer_dim=32, block_layout=True, block_masks=True,
                             factored_kernel=True)
    with pltpu.force_tpu_interpret_mode():
        _, want = dec_k.apply(variables["mask_decoder"], *map(jnp.asarray, inputs),
                              iou_only=True)
    with torch.no_grad():
        _, got = net.mask_decoder(*map(tt, inputs), iou_only=True)
    close(got, want)


def test_iou_only_bf16_matches_jax_factored_kernels_in_interpret_mode(weights):
    """The bf16 iou_only pass against the path the JAX package runs on a TPU
    in bf16: its decoder with the three Pallas kernels (interpret mode) on
    bf16 weights; the port's K2-K4 dispatches take their plain bf16
    versions on the CPU. Held to the amg_decode_iou budget (q99_rel)."""
    _, _, variables, net = weights
    emb, pe, sparse, dense = _decoder_inputs(B=16)
    # as the bf16 pipelines give them: the embedding and the no-mask dense
    # embedding (a weight) in bf16, the Fourier encodings in float32
    emb16, dense16 = (x.astype(ml_dtypes.bfloat16) for x in (emb, dense))
    dec_k = jsam.MaskDecoder(transformer_dim=32, block_layout=True, block_masks=True,
                             factored_kernel=True, dtype=jnp.bfloat16)
    v16 = jax_cast_float_params(variables["mask_decoder"], jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        _, want = dec_k.apply(v16, *map(jnp.asarray, (emb16, pe, sparse, dense16)),
                              iou_only=True)
    def t16(x):
        return tt(x.astype(np.float32)).to(torch.bfloat16)

    dec = copy.deepcopy(net.mask_decoder)
    cast_float_params(dec, torch.bfloat16)
    with torch.no_grad():
        _, got = dec(t16(emb16), tt(pe), tt(sparse), t16(dense16), iou_only=True)
    assert got.dtype == torch.bfloat16 and got.shape == (16, 4)
    err = q99_rel(got.float().numpy(), np.asarray(want).astype(np.float32))
    print(f"bf16 iou_only vs JAX's bf16 kernel path: q99_rel {err:.4f}")
    assert err <= BUDGETS["amg_decode_iou"], err


# ------------------------------------------------------------------ K1


@pytest.mark.parametrize("B,heads,hw,hd", [(1, 2, (8, 8), 16),    # global layout
                                           (2, 3, (7, 7), 16),    # windowed, N=49
                                           (3, 2, (3, 3), 8)])
def test_relpos_attention_plain_matches_pallas(B, heads, hw, hd):
    rng = np.random.RandomState(5)
    H, W = hw
    N = H * W
    q, k, v = (rng.randn(B, heads, N, hd).astype(np.float32) * s for s in (0.5, 0.5, 1.0))
    Rh = rng.randn(2 * H - 1, hd).astype(np.float32) * 0.1
    Rw = rng.randn(2 * W - 1, hd).astype(np.float32) * 0.1
    want = jax_relpos(*map(jnp.asarray, (q, k, v, Rh, Rw)), hw, interpret=True)
    qkv = np.concatenate([x.transpose(0, 2, 1, 3).reshape(B, N, heads * hd)
                          for x in (q, k, v)], axis=-1)
    got = attention_relpos.flash_attention_relpos(tt(qkv), tt(Rh), tt(Rw), hw, heads)
    close(got, np.asarray(want).transpose(0, 2, 1, 3).reshape(B, N, heads * hd),
          atol=RELPOS_ATOL, rtol=0)


# -------------------------------------------------------------- K2, K3, K4


def _state(rng, B=3, N=40, C=32, d=16, T=7, ranks=(9, 2, 9), scaled=(True, True, False)):
    blocks = tuple((rng.rand(B, r, N).astype(np.float32),
                    (rng.rand(B, N) + 0.5).astype(np.float32) if s else None)
                   for r, s in zip(ranks, scaled))
    R = sum(ranks)
    arr = {k: (rng.randn(*s) * sc).astype(np.float32) for k, s, sc in (
        ("S", (N, C), 1.0), ("U", (B, R, C), 0.3), ("UK", (B, R, d), 0.3),
        ("UV", (B, R, d), 0.3), ("q", (B, T, d), 0.3), ("KS", (N, d), 0.3),
        ("KC", (N, d), 0.3), ("VS", (N, d), 1.0))}
    arr["a"] = (rng.rand(B, N) + 0.5).astype(np.float32)
    return blocks, arr


def _torch_blocks(blocks):
    return tuple((tt(p), None if s is None else tt(s)) for p, s in blocks)


def _jax_blocks(blocks):
    return tuple((jnp.asarray(p), None if s is None else jnp.asarray(s)) for p, s in blocks)


@pytest.mark.parametrize("ranks,scaled,with_a", [((9,), (False,), False),
                                                 ((9, 2, 9), (True, True, False), True)])
def test_factored_ln_stats_plain_matches_pallas(ranks, scaled, with_a):
    blocks, x = _state(np.random.RandomState(6), ranks=ranks, scaled=scaled)
    a = x["a"] if with_a else None
    S = jnp.asarray(x["S"])
    with pltpu.force_tpu_interpret_mode():
        mu_w, inv_w = jfac.factored_ln_stats(
            _jax_blocks(blocks), jnp.asarray(x["U"]), S, S.mean(-1), (S * S).mean(-1),
            None if a is None else jnp.asarray(a))
    mu, inv = factored.factored_ln_stats(_torch_blocks(blocks), tt(x["U"]), tt(x["S"]),
                                         None if a is None else tt(a))
    close(mu, mu_w)
    close(inv, inv_w)


@pytest.mark.parametrize("ranks,scaled", [((9, 2), (True, False)),
                                          ((9, 2, 9, 2), (True, True, True, False))])
def test_factored_t2i_attention_plain_matches_pallas(ranks, scaled):
    """The port returns the head-diagonal blocks: held to the Pallas kernel
    composed with _heads_diag_out."""
    heads = 4
    blocks, x = _state(np.random.RandomState(7), ranks=ranks, scaled=scaled)
    qb = jsam._heads_block_q(jnp.asarray(x["q"]), heads, 4)
    with pltpu.force_tpu_interpret_mode():
        want = jfac.factored_t2i_attention(
            qb, jnp.asarray(x["UK"]), jnp.asarray(x["UV"]), _jax_blocks(blocks),
            jnp.asarray(x["a"]), *(jnp.asarray(x[k]) for k in ("KS", "KC", "VS")))
    got = factored.factored_t2i_attention(
        tt(x["q"]), tt(x["UK"]), tt(x["UV"]), _torch_blocks(blocks), tt(x["a"]),
        tt(x["KS"]), tt(x["KC"]), tt(x["VS"]), heads)
    close(got, jsam._heads_diag_out(want, heads, 4))


@pytest.mark.parametrize("ranks,scaled,with_a", [((), (), False),
                                                 ((9, 2), (True, False), True)])
def test_factored_i2t_scores_plain_matches_pallas(ranks, scaled, with_a):
    heads = 4
    blocks, x = _state(np.random.RandomState(8), ranks=ranks or (1,), scaled=scaled or (False,))
    blocks = blocks if ranks else ()
    a = x["a"] if with_a else None
    kbT = jsam._heads_block_q(jnp.asarray(x["q"]), heads, 4)
    uq = x["UK"] if ranks else None
    with pltpu.force_tpu_interpret_mode():
        want = jfac.factored_i2t_scores(
            kbT, None if uq is None else jnp.asarray(uq), _jax_blocks(blocks),
            None if a is None else jnp.asarray(a), jnp.asarray(x["KS"]),
            jnp.asarray(x["KC"]), heads)
    got = factored.factored_i2t_scores(
        tt(x["q"]), None if uq is None else tt(uq), _torch_blocks(blocks),
        None if a is None else tt(a), tt(x["KS"]), tt(x["KC"]), heads)
    assert got.shape == (3, 4 * 7 + 1, 40)
    close(got, want)


# ----------------------------------------------------------- small pieces


def test_masks_to_boxes_matches_jax():
    m = np.random.RandomState(9).rand(6, 12, 17) > 0.8
    m[2] = False                                  # empty mask: zeros
    m[3] = False
    m[3, 5, 16] = True                            # one pixel at the right edge
    np.testing.assert_array_equal(masks.masks_to_boxes(tt(m)).numpy(),
                                  np.asarray(jmasks.masks_to_boxes(jnp.asarray(m))))


def test_stable_top_k_breaks_ties_to_the_lower_index_as_jax():
    key = np.array([0.5, 0.9, 0.5, -np.inf, 0.9, 0.5, -np.inf, 0.1], np.float32)
    for k in (1, 3, 5, 8):
        np.testing.assert_array_equal(stable_top_k(tt(key), k).numpy(),
                                      np.asarray(jax.lax.top_k(jnp.asarray(key), k)[1]))


def test_weights_round_trip_and_checkpoint_load(tmp_path):
    """flax -> port -> convert_sam_state_dict -> flax is the identity, the
    windowed tables come back at 2*ws-1 rows, and a reference-named
    checkpoint file loads with strict=True."""
    _, pcfg = tiny_sam_cfgs()
    sd0 = random_sam_state_dict(sam.SAM(pcfg), seed=3)
    variables = convert_sam_state_dict({k: v.numpy() for k, v in sd0.items()},
                                       depth=3, grid=4)
    sd = sam_state_dict_from_flax(variables, pcfg)
    assert set(sd) == set(sd0)
    for k in sd0:
        np.testing.assert_array_equal(sd[k].numpy(), sd0[k].numpy(), err_msg=k)
    again = convert_sam_state_dict({k: v.numpy() for k, v in sd.items()}, depth=3, grid=4)
    jax.tree.map(np.testing.assert_array_equal, again, variables)
    torch.save(sd0, tmp_path / "sam_tiny.pth")
    net = sam.SAM(pcfg)
    assert load_reference_checkpoint(str(tmp_path / "sam_tiny.pth"), net) == []
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd0[k]), k
