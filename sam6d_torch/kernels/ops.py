"""The kernel entries as PyTorch operators: `torch.ops.sam6d.<name>`.

Each operator has exactly two implementations and a fake one:

- "CUDA": the hand-written kernel of the operands' one dtype, the fp32
  entry (`*_cuda`) or, for bfloat16 operands, the bf16 entry
  (`*_bf16_cuda`); FPS and the ball query take float32 only;
- "CPU": the plain PyTorch version of that dtype (`*_plain`,
  `*_bf16_plain`);
- fake (meta): the outputs' shapes, dtypes and strides, so that
  `torch.export` traces through the operator and keeps it as one node of
  the graph (`sam6d_torch/deploy/export.py`).

PyTorch's dispatcher picks the implementation from the tensors' device, so
a CUDA tensor never reaches a plain version, and a tensor on any other
device is refused. No operator has an autograd formula: no kernel has a
backward in the JAX package either (training calls FPS and the ball query
on detached clouds; PEM's ViT runs the plain attention).

The factored kernels take their scaled blocks ((Pd, s) pairs, s may be
None) as two lists, `pds` (Tensor[]) and `scales` (Tensor?[]), of equal
length. The launch counters stay on the `*_cuda` functions, which count a
launch where they make it.

The public dispatch functions of `fps.py`, `ball_query.py`,
`attention_qkv.py`, `attention.py`, `attention_relpos.py`, `factored.py` and
`nms.py` call these operators; importing `sam6d_torch.kernels` registers them.
"""
import torch

from . import attention, attention_qkv, attention_relpos, ball_query, factored, fps, nms
from .attention import operand_dtype

NAMESPACE = "sam6d"
OPS = {}        # name -> operator
_CUDA, _PLAIN = 0, 1   # positions in a (cuda, plain) pair of entry names


def _register(name, schema, module, fp32, bf16=None, *, fake, operands=None,
              blocks_at=None):
    """Define `sam6d::<name>` with `schema`. `fp32` and `bf16` name the
    (cuda, plain) functions of `module`, looked up at each call;
    `operands(*args)` gives the tensors whose one dtype picks the pair (bf16
    None: float32 only, no dtype routing). `blocks_at`: the position of the
    (pds, scales) lists, which the entry takes as one list of blocks."""

    def call(args, which):
        names = fp32
        if bf16 is not None:
            dtype = operand_dtype(name, *(t for t in operands(*args) if t is not None))
            names = bf16 if dtype == torch.bfloat16 else fp32
        if blocks_at is not None:
            at = blocks_at
            args = (*args[:at], _blocks(args[at], args[at + 1]), *args[at + 2:])
        return getattr(module, names[which])(*args)

    op = torch.library.custom_op(f"{NAMESPACE}::{name}", lambda *args: call(args, _PLAIN),
                                 mutates_args=(), device_types="cpu", schema=schema)
    op.register_kernel("cuda", lambda *args: call(args, _CUDA))
    op.register_fake(fake)
    OPS[name] = op
    return op


def _blocks(pds, scales):
    if len(pds) != len(scales):
        raise ValueError(f"{len(pds)} factor blocks but {len(scales)} scales")
    return list(zip(pds, scales))


# ---------------------------------------------------------------- K7: FPS


def _fps_fake(points, npoint, valid_mask):
    return points.new_empty((points.shape[0], npoint), dtype=torch.int32)


farthest_point_sample = _register(
    "farthest_point_sample",
    "(Tensor points, int npoint, Tensor? valid_mask) -> Tensor",
    fps,
    ("farthest_point_sample_cuda", "farthest_point_sample_plain"),
    fake=_fps_fake)


# --------------------------------------------------------- K6: ball query


def _ball_query_fake(xyz, new_xyz, r1, s1, r2, s2):
    B, M = new_xyz.shape[:2]
    return (xyz.new_empty((B, M, s1), dtype=torch.int32),
            xyz.new_empty((B, M, s2), dtype=torch.int32))


two_scale_ball_query = _register(
    "two_scale_ball_query",
    "(Tensor xyz, Tensor new_xyz, float r1, int s1, float r2, int s2) "
    "-> (Tensor, Tensor)",
    ball_query,
    ("two_scale_ball_query_cuda", "two_scale_ball_query_plain"),
    fake=_ball_query_fake)


# ------------------------------------------------ K5: attention off qkv


def _qkv_fake(qkv, heads, scale):
    B, N, C3 = qkv.shape
    return qkv.new_empty((B, N, C3 // 3))


fused_attention_qkv = _register(
    "fused_attention_qkv", "(Tensor qkv, int heads, float scale) -> Tensor",
    attention_qkv,
    ("fused_attention_qkv_cuda", "fused_attention_qkv_plain"),
    ("fused_attention_qkv_bf16_cuda", "fused_attention_qkv_bf16_plain"),
    operands=lambda qkv, *_: (qkv,), fake=_qkv_fake)


# ------------------------------------------- K8, K9: head-major attention

_HEAD_MAJOR = "(Tensor q, Tensor k, Tensor v, float scale) -> Tensor"


def _fused_attention_fake(q, k, v, scale):
    """K8's kernel writes a (B, Nq, H, hd) tensor and returns its (B, H, Nq,
    hd) view; the plain versions return a contiguous (B, H, Nq, hd)."""
    B, H, Nq, hd = q.shape
    stride = ((Nq * H * hd, hd, H * hd, 1) if q.device.type == "cuda"
              else (H * Nq * hd, Nq * hd, hd, 1))
    return torch.empty_strided((B, H, Nq, hd), stride, dtype=q.dtype, device=q.device)


def _fused_attention_small_fake(q, k, v, scale):
    return q.new_empty(q.shape)


fused_attention = _register(
    "fused_attention", _HEAD_MAJOR,
    attention,
    ("fused_attention_cuda", "fused_attention_plain"),
    ("fused_attention_bf16_cuda", "fused_attention_bf16_plain"),
    operands=lambda q, k, v, scale: (q, k, v), fake=_fused_attention_fake)

fused_attention_small = _register(
    "fused_attention_small", _HEAD_MAJOR,
    attention,
    ("fused_attention_small_cuda", "fused_attention_small_plain"),
    ("fused_attention_small_bf16_cuda", "fused_attention_small_bf16_plain"),
    operands=lambda q, k, v, scale: (q, k, v), fake=_fused_attention_small_fake)


# ------------------------------------------------- K1: SAM rel-pos attention


def _relpos_fake(qkv, rel_pos_h, rel_pos_w, hw, heads):
    B, N, C3 = qkv.shape
    return qkv.new_empty((B, N, C3 // 3))


flash_attention_relpos = _register(
    "flash_attention_relpos",
    "(Tensor qkv, Tensor rel_pos_h, Tensor rel_pos_w, int[] hw, int heads) -> Tensor",
    attention_relpos,
    ("flash_attention_relpos_cuda", "flash_attention_relpos_plain"),
    ("flash_attention_relpos_bf16_cuda", "flash_attention_relpos_bf16_plain"),
    operands=lambda qkv, rh, rw, *_: (qkv, rh, rw), fake=_relpos_fake)


# -------------------------------------------- K2-K4: the factored AMG pass


def _ln_stats_fake(pds, scales, Uc, S, a, eps):
    B, N = Uc.shape[0], S.shape[0]
    return (S.new_empty((B, N), dtype=torch.float32),
            S.new_empty((B, N), dtype=torch.float32))


def _t2i_fake(qp, UK, UV, pds, scales, a, KS, KC, VS, heads):
    return qp.new_empty(qp.shape)


def _i2t_fake(kt, UQ, pds, scales, a, QS, QC, heads):
    B, T, _ = kt.shape
    return kt.new_empty((B, heads * T + 1, QS.shape[0]))


factored_ln_stats = _register(
    "factored_ln_stats",
    "(Tensor[] pds, Tensor?[] scales, Tensor Uc, Tensor S, Tensor? a, float eps) "
    "-> (Tensor, Tensor)",
    factored,
    ("factored_ln_stats_cuda", "factored_ln_stats_plain"),
    ("factored_ln_stats_bf16_cuda", "factored_ln_stats_bf16_plain"), blocks_at=0,
    operands=lambda pds, scales, Uc, S, a, eps: (*pds, *scales, Uc, S, a),
    fake=_ln_stats_fake)

factored_t2i_attention = _register(
    "factored_t2i_attention",
    "(Tensor qp, Tensor UK, Tensor UV, Tensor[] pds, Tensor?[] scales, Tensor a, "
    "Tensor KS, Tensor KC, Tensor VS, int heads) -> Tensor",
    factored,
    ("factored_t2i_attention_cuda", "factored_t2i_attention_plain"),
    ("factored_t2i_attention_bf16_cuda", "factored_t2i_attention_bf16_plain"), blocks_at=3,
    operands=lambda qp, UK, UV, pds, scales, *rest: (qp, UK, UV, *pds, *scales,
                                                      *rest[:4]),
    fake=_t2i_fake)

factored_i2t_scores = _register(
    "factored_i2t_scores",
    "(Tensor kt, Tensor? UQ, Tensor[] pds, Tensor?[] scales, Tensor? a, Tensor QS, "
    "Tensor QC, int heads) -> Tensor",
    factored,
    ("factored_i2t_scores_cuda", "factored_i2t_scores_plain"),
    ("factored_i2t_scores_bf16_cuda", "factored_i2t_scores_bf16_plain"), blocks_at=2,
    operands=lambda kt, UQ, pds, scales, *rest: (kt, UQ, *pds, *scales, *rest[:3]),
    fake=_i2t_fake)


# ------------------------------------------- NMS to its fixed point (no TPU kernel)


def _nms_fake(overlap, valid):
    return (valid.new_empty(valid.shape, dtype=torch.bool),
            valid.new_empty((), dtype=torch.int32))


nms_fixed_point = _register(
    "nms_fixed_point", "(Tensor overlap, Tensor valid) -> (Tensor, Tensor)",
    nms,
    ("nms_fixed_point_cuda", "nms_fixed_point_plain"),
    fake=_nms_fake)
