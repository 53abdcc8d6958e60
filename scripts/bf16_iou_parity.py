"""The port's bf16 iou pass against the JAX package's bf16 kernel path, on the
CPU, for the checkout whose root is given (default: this one), so that two
commits can be compared:

    python scripts/bf16_iou_parity.py [ROOT]

Runs with JAX on the CPU and the JAX kernels in interpret mode. Prints:

- the factored LayerNorm (`TwoWayTransformer._ln_factored`) on one bf16
  factor state (B=8, N=512, C=32, blocks of 57, 2, 57 rows): the share of
  elements of a' = a / sigma, of the appended rows -mu / sigma and of block
  0's new scale that differ from the JAX package's kernel branch, and the
  largest difference;
- the tiny-width `iou_only` decode of `tests/test_torch_port_sam_modules.py`
  (16 point prompts, seeded weights cast to bf16): q99_rel of the port's
  bf16 IoU against JAX's bf16 decode through its three Pallas kernels, its
  XLA branch and its fp32 decode, and JAX's own bf16 kernel path against
  its fp32 decode.
"""
from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from sam6d_tpu.core.params import cast_float_params as jax_cast  # noqa: E402
from sam6d_tpu.models import sam as jsam  # noqa: E402
from sam6d_torch.core.numerics import q99_rel  # noqa: E402
from sam6d_torch.models import sam  # noqa: E402
from torch_port_common import tiny_sam_cfgs, tiny_sam_weights, tt  # noqa: E402

BF = ml_dtypes.bfloat16


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def t16(x):
    return None if x is None else torch.from_numpy(f32(x)).to(torch.bfloat16)


def j16(x):
    return None if x is None else jnp.asarray(x)


def ln_factored():
    rng = np.random.RandomState(0)
    B, N, C = 8, 512, 32
    S = rng.randn(N, C).astype(BF)
    a = (rng.rand(B, N) + 0.5).astype(BF)
    blocks = [(rng.rand(B, r, N).astype(BF), (rng.rand(B, N) + 0.5).astype(BF) if s else None)
              for r, s in zip((57, 2, 57), (True, True, False))]
    U = (rng.randn(B, 116, C) * 0.3).astype(BF)
    gamma, beta = (rng.rand(C) + 0.5).astype(BF), (rng.randn(C) * 0.1).astype(BF)
    tw = jsam.TwoWayTransformer(depth=2, embed_dim=C, num_heads=8, mlp_dim=64,
                                dtype=jnp.bfloat16, factored_kernel=True)
    with pltpu.force_tpu_interpret_mode():
        _, a2, bl2, _ = tw.apply({}, j16(gamma), j16(beta), j16(S), j16(a),
                                 tuple((j16(p), j16(s)) for p, s in blocks), j16(U),
                                 method=lambda m, *x: m._ln_factored(*x))
    ln = torch.nn.LayerNorm(C, eps=1e-6).to(torch.bfloat16)
    with torch.no_grad():
        ln.weight.copy_(t16(gamma))
        ln.bias.copy_(t16(beta))
        _, pa2, pbl2, _ = sam.TwoWayTransformer._ln_factored(
            ln, t16(S), t16(a), tuple((t16(p), t16(s)) for p, s in blocks), t16(U))
    for name, got, want in (("a' = a / sigma", pa2, a2),
                            ("appended rows -mu / sigma", pbl2[-1][0][:, 0], bl2[-1][0][:, 0]),
                            ("block 0's scale", pbl2[0][1], bl2[0][1])):
        got, want = f32(got), f32(want)
        print(f"factored LN, {name}: {100 * (got != want).mean():.2f}% of elements differ "
              f"from JAX's kernel branch, max |diff| {np.abs(got - want).max():.3g}")


def iou_only():
    _, pcfg = tiny_sam_cfgs()
    variables, sd = tiny_sam_weights(pcfg, rng=np.random.RandomState(1))
    net = sam.SAM(pcfg)
    net.load_state_dict(sd, strict=True)
    rng = np.random.RandomState(4)
    emb, pe, sparse, dense = (rng.randn(*s).astype(np.float32) * 0.3
                              for s in ((8, 8, 32), (8, 8, 32), (16, 2, 32), (8, 8, 32)))
    emb16, dense16 = emb.astype(BF), dense.astype(BF)
    want = {}
    for name, kernel, dt in (("bf16 kernel path", True, jnp.bfloat16),
                             ("bf16 XLA branch", False, jnp.bfloat16),
                             ("fp32", False, jnp.float32)):
        dec = jsam.MaskDecoder(transformer_dim=32, block_layout=True, block_masks=True,
                               factored_kernel=kernel, dtype=dt)
        bf16 = dt == jnp.bfloat16
        v = jax_cast(variables["mask_decoder"], dt) if bf16 else variables["mask_decoder"]
        ins = (emb16, pe, sparse, dense16) if bf16 else (f32(emb16), pe, sparse, f32(dense16))
        with pltpu.force_tpu_interpret_mode():
            _, want[name] = dec.apply(v, *map(jnp.asarray, ins), iou_only=True)
    dec = copy.deepcopy(net.mask_decoder).to(torch.bfloat16)
    with torch.no_grad():
        _, got = dec(t16(emb16), tt(pe), tt(sparse), t16(dense16), iou_only=True)
    for name, w in want.items():
        print(f"iou_only: the port's bf16 IoU against JAX's {name}: q99_rel "
              f"{q99_rel(f32(got), f32(w)):.4f}")
    print(f"iou_only: JAX's own bf16 kernel path against its fp32: q99_rel "
          f"{q99_rel(f32(want['bf16 kernel path']), f32(want['fp32'])):.4f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    print(f"checkout {ROOT}: {os.path.dirname(sam.__file__)}")
    ln_factored()
    iou_only()
